#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero before the last line is printed:

1. card   — the card's name and power limit (nvidia-smi) and torch's name;
2. build  — every CUDA kernel of the port, compiled from csrc/ (one nvcc
            per source, all started together);
3. kernel — the flash forward kernel (K1) held against its plain PyTorch
            version on the card at the serving shapes (B in 1/8/32/128,
            H=12, L=128, D=64, random key masks with fully masked rows,
            plus ragged lengths), in fp32 (atol 2e-5) and bf16 (atol 2e-2:
            p and O each take one bf16 rounding; lse compared in fp32);
            again on the layouts the model hands over (views of three
            [B, L, 768] projections, and the chunks of one fused
            [B, L, 2304] product) at the same bounds, with O stored as
            [B, L, H, D]; a misaligned or last-dim-strided input must
            raise and launch nothing. Then its time on the model's views
            beside its time on dense copies, the plain version's, SDPA's
            on the same views (a yardstick the port never calls) and the
            least time the card could take;
4. kernel-train — first the keep-mask read-out (q = k = 0, a one-hot v,
            one 64-key tile masked; B=2, H=3, L=128) in fp32 and bf16 at
            rates 0.1 and 0.5 with either key tile live: ``(O != 0)`` must
            equal keep_mask_reference bit for bit, and at rate 0.5
            ``32·O`` must equal it; and the same bits out of K2's dv and
            K3's dq (bwd_readout_inputs), compared exactly. Then at the
            training shapes (B=16, H=12, L=128, D=64, plus L in {40, 200},
            plus the model's split and fused views with dO in O's
            [B, L, H, D] layout; a fully masked row in all but one case):
            K1 with dropout at rate 0.1 against flash_attention_reference
            on the same seed words, and K3 + K2 through FlashAttention's
            backward against flash_backward_reference with dropout off
            and on, in fp32 (K1 atol 2e-5; gradients atol 1e-4, the JAX
            flash gradient bound) and bf16 (K1 atol 2e-2; gradients atol
            1e-5 + rtol 8e-3: both sides round one fp32 result to bf16,
            so they may differ by one bf16 ulp, at most 2^-7 relative);
            dbias atol 1e-3 (an fp32 sum over H·Lq terms in another
            order); flash_backward must copy no dO, return dq/dk/dv as
            [B, L, H, D] storage, and give the same bits twice. Then the
            times of K1 with dropout (on the model's views, and on dense
            copies), K3 and K2 at B=16 bf16 on the model's layout, each
            beside its plain version's, SDPA's (forward with dropout, and
            its backward alone: a yardstick the port never calls) and its
            bound;
5. path   — full-width DistilBERT-base (6 layers, dim 768, 12 heads,
            L=128, flash attention, bf16) with seeded random weights,
            added to the port's registry and promoted to serving through
            its ``registry`` verb, and served by the port's
            ``infer-serve`` on the card; a few dozen concurrent text and
            features requests through the port's client. Every prob must
            be finite in [0, 1] and match the same weights through
            attention_impl="dot" on the card (bf16 atol 1e-2), and the
            kernel must have launched once per layer of every batch;
6. train  — ``local`` at full width (``--preset distilbert
            --attention-impl flash --synthetic 2400 --epochs 1``: 9 steps
            of bs16 with dropout on, then val and test evaluation) through
            the port's parser. K1 with dropout, K2 and K3 must launch once
            per layer of every step (and the backward copy no dO), K1 at
            rate 0 once per layer of every eval batch; every loss and the
            metrics CSV must be finite. ``--checkpoint-dir`` saves the
            state once (params and Adam moments): its seconds and bytes.
            Then 108 more steps (the epoch's 9 batches 12 times) time the
            steady training samples/s. Then one fp32 step
            with dropout off: gradients through flash against the dot path
            on the card (atol 1e-4 + rtol 1e-3); and 20 steps on one fixed
            batch with dropout off must bring the loss below its first
            value;
   lifecycle — at full width on the card: (a) 4 steps, save, warm start
            into a fresh trainer, 5 more steps, dropout on, against 9
            uninterrupted steps: losses and params within the trajectory
            bound (atol 2e-6 / rtol 1e-5), printed whether bit-equal, with
            the save's and the restore's seconds; (b) ``predict`` on 512
            synthetic flows from phase 6's checkpoint, and again from the
            resumed state's: probs bit-equal to ``Trainer.evaluate`` on the
            restored state, flows/s, K1 once per layer of every batch;
            (c) ``infer-serve --checkpoint-dir`` while the resumed state is
            finalized as a new step, and ``infer-serve --registry-dir``
            while it is promoted as a second artifact: replies after the
            swap name the new round, their probs within bf16's bound (atol
            1e-2) of ``predict`` on the new weights, which must differ
            from the old ones by more than 10 x that bound on some served
            text, so a stale serve fails; the seconds from the swap to the
            first reply the new model scored;
7. kernel-fold — the fold kernel K4 against its plain version on the
            card and against numpy's ``acc += float32(w) * x`` on the
            host, with no tolerance (``array_equal``): K in {1, 2, 8} over
            the word-embedding leaf (23,440,896 elements) and n in {1, 3,
            768, 32769}, scales 10^-4..10^4, subnormal inputs, repeated
            calls giving the same bits. Then the times at K=2 and K=8 on
            that leaf, beside the plain version's, ``torch.mv``'s (a
            yardstick the port never calls) and the bound, and the
            aggregator's host-to-device copies, kernel and copy back;
   federated — the ``federated`` verb at full width (DistilBERT-base,
            flash, bf16, dropout on, Adam 2e-5, bs16) with 4 clients on
            1600 synthetic flows cut by ``--partition quantity`` into
            shards of 644 / 386 / 414 / 156 rows (the shortest idles
            through each epoch's tail), 2 epochs a round, ``--weighted``,
            with ``--checkpoint-dir`` and ``--registry-dir``: round 1 as one
            invocation, round 2 as a second that resumes from its
            checkpoint. Checks: K1 with dropout, K2 and K3 once per layer
            of every client-step that ran, K1 at rate 0 once per layer of
            every eval client-batch; after each aggregation every client
            row bit-equal to row 0 and row 0 within atol 1e-6 of the fp64
            weighted mean of the rows before it; a client idling through a
            gated step keeps its params, moments and Adam count bit for
            bit; ``predict`` on round 2's checkpoint bit-equal to
            ``evaluate_clients`` row 0; ``infer-serve --checkpoint-dir``
            started on round 1 swaps to round 2 when the resumed run
            finalizes it, its replies within bf16's bound of round 2's
            ``predict``, which must differ from round 1's by more than 10 x
            that bound on some served text; one registry artifact a round
            with ``extra`` ``{"tier": "mesh", "clients": 4}``. Prints each
            round's seconds by phase, samples/s over all clients and the
            peak device memory;
   train-options — ``local --remat`` with a ``--config`` file written by
            the port's ``export-config`` with ``train.grad_accum_steps``
            3: 9 micro steps, Adam's count 3, K1 with dropout twice per
            layer of every step (remat's recompute) and K2, K3 once; one
            step from one state with and without remat (loss, params and
            the dropout generator compared: the largest difference is
            printed, atol 2e-6 + rtol 1e-5); the peak device memory of one
            bs64 step with and without remat (remat's must be lower);
   distill — ``distill`` with a fresh 12-layer teacher (9 steps) and a
            6-layer student (9 KD steps, the teacher at rate 0 in each):
            student layer i equal to teacher layer 2i at init, the teacher
            unchanged after distillation, launches as predicted, the card's
            KD loss within rtol 1e-5 of float64 on the same logits; then
            ``--teacher-checkpoint`` (phase 6's directory) ``--student-layers
            3`` and ``predict`` on the student's checkpoint;
   migrate — ``export-hf`` of phase 6's directory; ``predict --hf-dir``
            against ``predict --checkpoint-dir`` (the same model config,
            atol 1e-6, the largest difference printed); a reference-style
            ``.pth`` from the export, ``predict --hf-dir --pth`` and
            ``export-hf --pth`` (the same ``model.safetensors`` bytes);
            ``local --hf-dir`` (9 steps); ``infer-serve --hf-dir --pth``
            answering 32 flows within bf16 atol 1e-2 of ``predict``; then
            ``client --hf-dir`` twice in a one-round ``serve --num-clients
            2`` (K4 once per leaf, both aggregates equal), ``federated
            --hf-dir`` for one round, ``distill --hf-dir`` (the encoder
            warm-starts a 6-layer teacher) and ``distill --hf-dir --pth``
            (the .pth is the teacher), each to a 3-layer student, all with
            finite losses;
   privacy — (a) at full width, four clients' round results (the seeded
            init plus deltas of norm 0.25, 0.5, 2 and 4 x the clip 1.0):
            ``FederatedTrainer.aggregate`` with DP at noise 0 on the card
            within rtol 1e-5 (of the terms' magnitude) of the float64
            numpy clipped mean, every row equal, the update norms within
            rtol 1e-5 of float64's, the 4x client alone scaled to the clip
            within 1e-5; (b) the std of (noised - noiseless) over the whole
            model within 1% of noise x clip / n; (c) ``federated --config``
            (``train.grad_accum_steps`` 2) ``--dp-clip 1.0
            --dp-noise-multiplier 1.1 --participation 0.5`` (Poisson)
            ``--personalize-epochs 1 --personalize-scope full``, 4 clients,
            ``--partition quantity``, 2 rounds: the ``[DP]`` banner's two
            epsilons equal to ``dp_epsilon_both`` for 2 rounds at q 0.5,
            each client's Adam count and mini step those of its micro
            steps, an idle client's window unchanged through a gated step,
            K1 with dropout, K2 and K3 once per layer of every micro
            client-step (personalization included), K1 at rate 0 once per
            layer of every eval client-batch, a finite
            ``client{c}_personalized_metrics.csv`` each; then ``personalize``
            at scope ``head``: every encoder leaf bit-equal, the head moved,
            K2 and K3 not launched;
   dp-rounds — ``serve --num-clients 2 --dp-clip 1.0`` with two ``client
            --dp`` at full width, the fold on the card: (a) noise 0, the
            reply delta bit-equal to numpy's fp32 fold of the clipped
            uploads; (b) 3 rounds at noise 1.0, ``--dp-participation 0.5``
            (the cohort draws scripted so each client sits a round out),
            ``--dp-history-file``, FEDTPU_SECRET set (the sit-out goes
            through ``DPSK``): both clients' bases bit-equal every round,
            3 deltas in the history file; (c) a client that drops a reply
            healed by the composed resync, bit-equal to the fleet. K4 once
            per leaf of every round that released;
   stream — ``--stream`` over a 20,000-row CSV with NaN/inf cells: on a
            clean one the token arrays equal the in-memory loader's
            (disjoint, dirichlet), on the noisy one the labels and shapes
            and most rows; ``local --stream``, ``federated --stream`` and
            ``distill --stream`` for one epoch with finite losses;
8. round    — one FedAvg round of full-width DistilBERT-base on loopback:
            the port's ``serve`` (2 clients, fold on the card) in a
            thread and two port ``client``s in threads (``--preset
            distilbert --attention-impl flash --synthetic 2400 --epochs 1
            --rounds 1``), all through the port's parser. K4 must launch
            once per parameter leaf (102); both clients must receive the
            same bytes, whose crc equals that of ``fold_reference`` over
            the two uploads as sent; K1 with dropout, K2 and K3 once per
            layer of every step of both clients; both aggregated metrics
            CSVs finite. Prints the round's time split;
9. rounds   — the streamed round over 3 rounds at full width (phase 8's
            clients with ``--rounds 3``; the stream offer rides the
            reply, so round 1 is dense and rounds 2-3 stream), in two
            invocations of ``serve`` + two ``client``s, fold on the card:
            (a) FEDTPU_SECRET set, the default 4 MB chunks, ``--strategy
            fedprox:mu=0.01`` and ``--prox-mu 0.01`` on both clients:
            round 1 dense and rounds 2-3 streamed per client by the
            server's record, every reply carrying the nonce and the
            fedprox stamp, each round's aggregate crc equal to
            ``fold_reference`` over the uploads as sent; (b) ``--reply-dtype
            bf16 --strategy fedopt:opt=adam,lr=0.1``, client 0 ``--wire-dtype
            int8`` (int8c streams from round 2, bf16 streamed replies),
            client 1 ``--compression topk:0.01 --no-stream-upload`` (sparse
            deltas from round 2; its dense fp32 replies keep its base
            exact): the mean bit-equal to ``fold_reference`` over the
            uploads as decoded (int8c dequantized, base + densified top-k,
            replayed with the client's error feedback), each int8c value
            within half its chunk's step (plus two fp32 ulps), top-k keeping
            ``max(1, round(0.01·n))`` entries a leaf, the bf16 reply within
            2^-8 relative of the server's global, and that global equal to
            ``ServerOptimizer`` run on the card over the same means. Both:
            K4 once per leaf a round (102) on ``cuda``; K1 with dropout, K2
            and K3 once per layer of every step; K1 at rate 0 once per layer
            of every eval batch; no dO copy. Prints a line per round with
            the card: bytes and seconds of each upload and reply, the
            fold's early and late bytes and seconds, K4's launches and
            time, the server's phases and the round's wall. The native wire
            (``comm/native.py`` over ``native/fedwire.cpp``) must be
            active; on a full-width upload its CRC equals zlib's and its
            bf16 pack the numpy twin's; prints the host seconds of the
            CRC and of a bf16 upload's encode, native and numpy;
10. serving — at full width on the card, through the port's parser:
            (a) ``infer-serve --registry-dir --auth --reload-poll 3600``
            with FEDTPU_SECRET set: a client with no key and one with a
            wrong key are dropped (``rejects["auth"]`` 2); 64 sync
            requests (a lone one first: bucket 1), then ``run_load``
            closed loop (16 connections x 8 in flight, 2048 requests over
            256 flows, half text, half features), open loop at half the
            closed loop's flows/s (1024), the arrival trace
            tests/data/arrival_bursty.trace (512), and 64 concurrent
            ``AsyncScoringClient`` scores on one connection; prints each
            mode's flows/s, p50/p95/p99 ms and batch sizes. Checks: the
            server's ``scored`` equals the replies counted, ``score_hist``
            sums to it, buckets 1/8/32/128 all hit, K1 at rate 0 once per
            layer of every batch and never with dropout, the sampled and
            asyncio replies within bf16 atol 1e-2 of the dot path; (b) a
            second artifact (the classifier bias moved by +-2) promoted and
            one reload frame sent: the reply says reloaded, round 2, with
            no wait for the poll; the next replies name round 2 and lie
            within atol 1e-2 of the dot path on the new weights, which
            differ from the old ones by more than 10 x that bound; (c)
            ``local --dataset unswnb15`` (9 steps; K1 with dropout, K2, K3
            once per layer of every step, a finite metrics CSV), its
            checkpoint served with ``--dataset unswnb15`` (64 UNSW features
            replies within atol 1e-2 of the dot path on the same texts), and
            a K=7 artifact served with ``--dataset cicddos2019-mc`` (7
            class_probs summing to 1 within 1e-5, prob = 1 - class_probs[0]
            within 1e-6, within atol 1e-2 of the dot path); (d) the native
            WordPiece encoder active, its ids on every served text equal
            to the Python encoder's, microseconds a flow for both; (e)
            ``infer-serve --hf-dir --max-len 64`` on the same weights: 32
            flows at L=64 within bf16 atol 1e-2 of an fp32 scorer at L=64
            on the CPU;
11. obs     — the obs layer on the card, through the port's parser, at
            full width: (a) ``local`` at phase 6's configuration (bs16,
            9 steps) with ``--profile-stride 3 --metrics-jsonl
            --trace-jsonl --profile-dir``: 3 samples each of host,
            dispatch and device (and ``fedtpu_train_step_seconds``
            counting them), a ``post-first-step`` peak above 0 and at
            most ``torch.cuda.max_memory_allocated()``, the Chrome
            trace's K1/K2/K3 kernel events (by substring of their
            mangled names; a trace without CUDA kernel events fails)
            equal to the launch counters over the fit (and the device's
            busy share over the traced kernels printed), and the device
            share of a sampled step printed (and again at stride 1
            without the profiler, whose host cost inflates the
            dispatch); (b) before it, the same fit
            at stride 0 with ``torch.cuda.synchronize`` counted: 0 calls
            and no ``fedtpu_*_step_seconds`` family; (c) ``obs profile
            --preset distilbert --steps 12 --capture DIR --json``: the
            counted/analytic FLOPs ratio (printed, inside 0.5-2.0), MFU
            against the card's peak, ``peak_device_bytes``,
            ``compile_count``, a serving storm with 0 recompiles, CUDA
            kernels in the capture; (d) ``serve --num-clients 2
            --trace-jsonl --metrics-port`` with two ``client
            --trace-jsonl --profile-stride 3`` at phase 8's configuration
            (their spans' sampled step attrs printed): ``/metrics`` and
            ``/metrics.json`` agree, the round counter moves by 1 and the
            byte counters by the bytes the clients sent and received,
            ``obs timeline`` attributes each client's wall within 10%,
            K4 launches 102; (e) ``infer-serve --metrics-port 0
            --trace-sample 0.25 --scored-jsonl --flight-dir
            --trace-jsonl --profile-stride 2`` over 64 flows and a
            reload frame (the sampled score dispatch's split printed):
            ``fedtpu_serve_scored_total`` counts every answer, one scored
            row per reply with its prob, one ``serve-batch`` span per
            stride of 4 batches, one ledger signature per bucket and no
            recompile after the reload, no postmortem bundle;
12. control — the watched deployment loop, through the port's parser,
            at full width: ``controller --num-clients 2 --rounds 2
            --drift-jsonl --sentinel-jsonl --max-interval 900
            --gate-min-delta 100 --round-deadline 600 --slo-alerts-jsonl
            --metrics-port --trace-jsonl`` on the card (the fold K4, the
            gate K1 at rate 0 on the pooled validation rows) with two
            ``client``s of phase 8's cell, and ``infer-serve
            --registry-dir --reload-poll 0.2 --metrics-port
            --metrics-jsonl --scored-jsonl`` from round 0's promotion on.
            (b) ``obs watch --slo`` over the controller from the start,
            with a 1 s round-duration objective: one fire after round 0,
            and round 1's record says ``slo_tightened`` (its straggler
            deadline halved); ``obs health --json`` over both daemons:
            exit 0, both up,
            ``fedtpu-health-v1``; then ``obs health --slo`` with a 1 ms
            queue-wait objective, ``--alerts-jsonl --alert-cmd``, 80 flows
            sent between its polls: exit 1, exactly one
            ``fedtpu-alert-v1`` fire, one ``--alert-cmd`` run. (c) ``obs
            sentinel --canaries tests/data/canary_flows.jsonl
            --canary-preset cicids2017 --registry-dir --ring-jsonl`` with
            its journal tail (``--scored-jsonl --labels-journal
            --reference-error 0.05 --verdicts-jsonl``): 3 ticks at round
            0's artifact, then delayed labels that every served flow was
            misjudged, whose verdict the controller's sentinel link turns
            into round 1; 3 ticks after the scorer followed round 1's
            promotion: no incident, no canary score moving at a fixed
            artifact, the canary latency histogram counting canaries x
            ticks. (a) The state file reads bootstrap, the error-rate
            drift trigger, round 1 by drift; each promoted artifact is
            bit-equal to numpy's fp32 fold of the two uploads, its id the
            content address of that fold, its gate metrics equal to
            ``Trainer.evaluate`` of it again on the card, its
            ``eval_hist`` the histogram of the gate's probs; the gate
            launched K1 6 x ceil(val rows / 16) times a round, K4 102 a
            round; the scorer's replies name round 1 after it. Prints the
            cycle split (round wall, gate eval, registry add, promote),
            the promotion latency, the canary p50/p99, each tick's
            buckets and the hub's scrape lag;
13. robust — the robustness planes, through the port's parser, at full
            width (clients of the round cell's 1200 rows each). (a)
            ``serve --num-clients 3 --min-clients 2 --secure-agg
            --secure-protocol double`` under ``FEDTPU_SECRET`` with three
            ``client --secure-agg --min-participants 2``; client 2 dials
            through a FaultProxy that resets it 4 KiB into its upload,
            after its shares, and has one attempt. The round unmasks over
            the survivors at its 45 s deadline: the aggregate equals
            ``dequantize_sum(sum(quantize(u)))`` over their uploads bit
            for bit and ``aggregate_flat`` within 2·2^-24; both received
            it and adopted it on the card; K4 0 launches; K1–K3 as the
            train cell per client. Prints the round wall, each client's
            masking, keys and shares seconds, the unmask round and the
            ring sum. (b) a root ``serve --num-clients 2 --min-clients 1
            --weighted``, two ``relay --num-clients 2`` and four
            ``client --parent ... --parent ...`` (own relay first) for two
            rounds; relay B's clients reach it through a DeadRelayFault
            whose seeded kill lands in round 2's uploads. Round 1: each
            relay's partial equals ``aggregate_flat`` of its subtree, the
            root crc-equal to ``aggregate_tree`` over [[0, 1], [2, 3]], K4
            3 x 102. Round 2: B's clients re-home to relay A (held until
            they registered there), the root completes a degraded round
            crc-equal to ``aggregate_tree`` over its recorded assignment,
            ``fedtpu_client_rehomes_total`` +2. (c) ``scenario`` (the
            default matrix: lazy, slow, intermittent x iid, dirichlet,
            the auth cell, the dead-relay cell) and one ``--train`` cell
            through ``cli_main``: exit 0, every round ok and crc-exact,
            K4 launched by the cells' servers;
14. gates  — the gate stack, through the port's parser, at full width,
            one secret (``FEDTPU_SECRET``) keying the whole phase. (a)
            ``fleet --replicas 2 --buckets 1,8,32 --auth --shadow-sample
            2`` following a registry: 256 flows' replies within bf16 atol
            1e-2 of a lone ``ScoreEngine`` on the artifact; a 256-flow
            closed loop (8 connections) answered by both replicas, whose
            stats frames name replicas 0 and 1; a second artifact (its
            head shifted so its scores differ by more than 0.1 on every
            flow) promoted under a 1024-flow closed loop: 0 rejected, a
            sampler's every reply within 1e-2 of the lone engine of the
            round it names, one registry ``reload`` event and one
            ``replica-drain`` span per replica, every reply after the
            sweep round 2; ``route --auth`` in front of the replicas:
            replies equal to a replica's own, a keyless client refused.
            (b) the shadow gate on exactly 64 mirrored pairs (stride 2):
            the serving weights with the bias nudged 1e-6 pass (flip rate
            0) and the fleet rolls onto them; the head negated fails
            (flip rate 1), is rejected with the verdict on the registry's
            ``rejected`` event, the pointer held; each verdict equals
            ``evaluate_status`` of the pairs JSONL recomputed. (c)
            ``controller --shadow-gate --label-gate --error-drift`` (the
            shadow thresholds open, so the label rung rules) runs the
            round cell for one round; 112 labelled flows through the
            router, their truth ingested, then 16 more: the record's
            shadow verdict equals ``evaluate_status`` and its label
            verdict ``evaluate_supervised`` recomputed from the pairs
            and the journal, the registry's event agrees with the
            record, the shadow pointer is cleared; K4 102, K1-dropout, K2
            and K3 once per layer of every client step. Prints the live
            p99 without and with the mirror, each replica's sweep time;
15. mesh   — the mesh tier on two slots of the card: the meshed and FSDP
            trainers against one device, the sharded scorer, the mesh
            flags through the CLI, ``federated`` as two gloo processes;
16. seq    — sequence parallelism at DistilBERT-base width on seq slots of
            the card (every slot names cuda:0): (a) ``FedSeqTrainer``
            (2 clients, L=512, bs8, 3 lockstep steps, dropout on) over
            1, 2 and 4 seq slots, the fp32 losses at seq 2 and 4 within
            2e-4 of seq 1 and off the dropout-off run's, the ring
            forward within 2e-4 of the dot path (fp32, dropout off),
            bf16 deviations and every step time printed; (b)
            ``federated --seq-parallel 2`` for two rounds, round 2
            resumed from round 1's checkpoint bit-equal, a DP-FedAvg
            round at noise 0 within 2e-6 of the plain mean; (c) ``serve``
            and two ``client --seq-parallel 2`` processes, one round, K4
            once a leaf and the aggregate's crc the plain fold's; (d)
            two gloo processes of ``federated --seq-parallel 2``
            bit-equal to one. No flash kernel launches on the ring path;
17. the kernels' JSON line (K1 as its two instantiations, rate 0 at the
   serving shape and dropout at the training shape, then K2, K3 and K4;
   K1's rate-0 launches count phase 5, phase 6's evaluation, the
   lifecycle's predict and reload serving, the federated phase's
   evaluations, predicts and serving, the train-options, distill,
   migrate, privacy, dp-rounds and stream phases, the rounds phase's
   evaluations, the serving phase, the obs phase, the control phase
   the robust phase's clients and the gates phase's replicas, shadow
   replicas and gate; K1 with dropout, K2 and K3 count
   phase 6, the federated, train-options, distill, migrate, privacy,
   dp-rounds, stream and rounds phases, the serving phase's ``local``,
   the obs phase, the control, robust and gates phases' clients;
   K4 the migrate and dp-rounds phases, phases 8 and 9, the obs
   phase's round, the control phase's two rounds, the robust
   phase's relays, roots and scenario servers, the gates phase's
   round, the mesh phase's client rounds and the seq phase's round),
   then the result line
   ``{"ok": true, "device": {...}}``.

Needs CUDA: without a card (or without the repository beside it) it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import csv
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch import (
    obs as obs_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    build_parser,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    main as cli_main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import (
    build_relay,
    build_server as build_round_server,
    run_client,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.control import (
    build_controller,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.distill import (
    run_distill,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.federated import (
    run_federated,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.local import (
    run_local,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.predict import (
    run_export_hf,
    run_predict,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    native as wire_native,
    wire,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
    FederatedClient as PortFederatedClient,
    aggregate_flat,
    aggregate_tree,
    secure as psecure,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.wire import (
    WireError,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.faults import (
    DeadRelayFault,
    FaultProxy,
    FaultSpec,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.faults.deadrelay import (
    wait_registered,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.quant import (
    QUANT_CHUNK_ELEMS,
    dequantize_int8c,
    quantize_int8c,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.obs import (
    build_hub,
    build_sentinel,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.router import (
    build_fleet,
    build_router,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.serving import (
    build_server,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FedConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.control.drift import (
    psi as drift_psi,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data import (
    FLOW_TEXT_COLUMNS,
    default_tokenizer,
    flow_to_text,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
    frame_texts,
    load_flow_csv,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
    TokenizedSplit,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.datasets import (
    get_dataset,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.synthetic import (
    make_synthetic,
    make_synthetic_flows,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.labels import (
    LabelStore,
    evaluate_supervised,
    journal_path as label_journal_path,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.distilbert import (
    build_trainable_params,
    model_skeleton,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.hf_convert import (
    hf_dir_has_head,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.safetensors import (
    load_file as load_safetensors,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import (
    _build,
    flash_attention as flash_mod,
    fold as fold_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops.attention import (
    make_attention_bias,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.device import (
    resolve_device,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.convert import (
    params_to_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel import (
    mesh as mesh_mod,
    multihost as multihost_mod,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.fedseq import (
    make_seq_mesh,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.router.fleet import (
    FleetReplica,
    ServingFleet,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.fedavg import (
    ServerOptimizer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.mesh import (
    ShardedLeaf,
    device_tree_bytes,
    make_host_mesh,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
    ModelRegistry,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry.store import (
    artifact_id,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.serving import (
    AsyncScoringClient,
    PipelinedScoringClient,
    ScoreEngine,
    ScoringClient,
    fetch_stats,
    load_arrival_trace,
    run_load,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.shadow import (
    ShadowGate,
    evaluate_status,
    pairs_path as shadow_pairs_path,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.checkpoint import (
    STATE_FILE,
    Checkpointer,
    maybe_warm_start,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.batches import (
    federated_batches,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.client_mesh import (
    FedSeqClientTrainer,
    FsdpMeshTrainer,
    MeshTrainer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.distill import (
    DistillTrainer,
    distillation_loss,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.engine import (
    Trainer,
    loss_fn,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.fedeval import (
    reference_histogram,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.federated import (
    FederatedTrainer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.train.seqfed import (
    FedSeqTrainer,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.utils import (
    native,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.utils import (
    profiling as profiling_mod,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
BUCKETS = (1, 8, 32, 128)
H, L, D = 12, 128, 64
B_TRAIN = 16  # DataConfig.batch_size
STEADY_PASSES = 12  # passes over the epoch's 9 batches timed for samples/s
RATE = 0.1  # ModelConfig.attention_dropout
PORT = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch"
JAX_FLASH = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu/ops/flash_attention.py"
JAX_FOLD = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu/ops/fold.py"
EMBED_N = 30522 * 768  # the word-embedding leaf, DistilBERT-base's largest
# The federated phase: 1600 synthetic flows cut by the quantity skew into
# 4 disjoint shards of 644 / 386 / 414 / 156 rows (train 386 / 231 / 248 /
# 93: 25 / 15 / 16 / 6 steps of bs16 an epoch), so the shortest client
# idles through the tail of every epoch. Two epochs a round: after one,
# round 1's model is still at chance and scores too like round 2's for the
# stale-weights guard to tell them apart with room to spare.
FED_CLIENTS = 4
FED_ARGS = ["--synthetic", "1600", "--num-clients", str(FED_CLIENTS), "--partition", "quantity",
            "--dirichlet-alpha", "2.0", "--data-fraction", "0.25", "--epochs", "2", "--weighted"]
# The rounds phase: the round phase's clients over 3 rounds, so the stream
# offer (one reply behind) is taken from round 2 on.
ROUNDS = 3
ROUND_CLIENT_ARGS = ["--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400",
                     "--epochs", "1", "--rounds", str(ROUNDS), "--timeout", "600"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_T0 = time.monotonic()


def phase(name: str) -> None:
    """Announce a phase, with the seconds since the script started."""
    print(f"== {name} (at {time.monotonic() - _T0:.1f} s)", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b: int, h: int, l: int, d: int, elsize: int) -> tuple[float, str]:
    """Least time (ms) for one forward: q, k, v, O once each, lse and the
    key bias; 2 products of 2·L·L·D flops per (b, h) at the bf16 peak."""
    nbytes = 4 * b * h * l * d * elsize + b * h * l * 4 + b * l * 4
    flops = 4 * b * h * l * l * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def backward_bound(b: int, h: int, l: int, d: int, elsize: int, kernel: str) -> tuple[float, str]:
    """Least time (ms) for K2 ("dkdv") or K3 ("dq"), each input read once
    and each output written once: q, k, v, dO, lse, the key bias, and for
    K2 the delta K3 wrote, out dk, dv and the fp32 per-head dbias rows;
    for K3 also O, out dq and delta. 4 (K2) or 3 (K3) products of 2·L·L·D
    flops per (b, h) at the bf16 peak."""
    rows = b * h * l
    tile = rows * d * elsize
    nbytes = 4 * tile + rows * 4 + b * l * 4  # q, k, v, dO, lse, key bias
    if kernel == "dkdv":  # delta in; dk, dv and the dbias rows out
        nbytes += rows * 4 + 2 * tile + rows * 4
        flops = 4 * 2 * b * h * l * l * d
    else:  # O in; dq and delta out
        nbytes += 2 * tile + rows * 4
        flops = 3 * 2 * b * h * l * l * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def split_heads(t: torch.Tensor) -> torch.Tensor:
    """``[B, L, H*D] -> [B, H, L, D]``, a view: the model's ``split``."""
    b, l, _ = t.shape
    return t.reshape(b, l, H, D).transpose(1, 2)


def attention_inputs(g, b, l, dtype, fully_masked_row, layout="dense"):
    """q, k, v ``[b, H, l, D]`` and a key bias. ``layout``: "dense"
    (contiguous), "split" (views of three ``[b, l, H*D]`` projections, as
    the model's separate q/k/v hand them over) or "fused" (the chunks of
    one ``[b, l, 3*H*D]`` product, the model's ``fused_qkv``)."""
    if layout == "dense":
        q, k, v = (
            torch.randn(b, H, l, D, generator=g, device="cuda").to(dtype)
            for _ in range(3)
        )
    elif layout == "split":
        q, k, v = (
            split_heads(torch.randn(b, l, H * D, generator=g, device="cuda").to(dtype))
            for _ in range(3)
        )
    else:
        qkv = torch.randn(b, l, 3 * H * D, generator=g, device="cuda").to(dtype)
        q, k, v = (split_heads(t) for t in qkv.chunk(3, dim=-1))
    mask = (torch.rand(b, l, generator=g, device="cuda") > 0.3).to(torch.int32)
    mask[:, 0] = 1
    if fully_masked_row:
        mask[-1] = 0  # a bucket pad row: every key masked
    return q, k, v, make_attention_bias(mask)


#: The keep-mask read-out's shape (B, H, L): both 64-row query tiles, a
#: nonzero batch and head index, and both 64-key tiles are read.
READOUT = (2, 3, 128)
KEY_TILE = 64


def readout_inputs(dtype, live_tile: int, device="cuda"):
    """The keep-mask read-out: q = k = 0, ``v[key, d] = 1`` iff
    ``d == key % 64``, and every key outside the 64-key tile ``live_tile``
    masked by the bias. Every live key then scores 0 and gets p = 1 and
    l = 64, so ``O[b, h, q, d] = keep(b, h, q, 64·live_tile + d) · inv / 64``:
    O is nonzero exactly where the keep bit is set, and at rate 0.5
    ``32·O`` is the mask itself. A keep bit hashed at a wrong fragment
    coordinate moves O by ~0.009 at L=128, inside the bf16 bound of 2e-2,
    so only this read-out catches it."""
    b, h, l = READOUT
    q = torch.zeros(b, h, l, D, dtype=dtype, device=device)
    keys = torch.arange(l, device=device)
    v = (keys[:, None] % D == torch.arange(D, device=device)).to(dtype)
    v = v.expand(b, h, l, D).contiguous()
    mask = torch.zeros(b, l, dtype=torch.int32, device=device)
    mask[:, live_tile * KEY_TILE : (live_tile + 1) * KEY_TILE] = 1
    return q, q.clone(), v, make_attention_bias(mask)


def bwd_readout_inputs(dtype, live_tile: int, kernel: str, device="cuda"):
    """The backward's keep-mask read-out, ``(q, k, v, dO)`` at the
    read-out shape with no bias: q = 0, so every score is 0 and p = 1/L.

    K2 (``kernel="dkdv"``): k = 0, v = 1 and ``dO[q, d] = 1`` iff query q
    lies in the 64-query tile ``live_tile`` and ``d == q % 64``. Then
    ``dv[key, d] = y[64·live_tile + d, key] = keep · inv / L``: dv is
    nonzero exactly where the keep bit of (query 64·live_tile + d, key)
    is set.

    K3 (``kernel="dq"``): ``k[key, d] = 1`` iff key lies in the 64-key tile
    ``live_tile`` and ``d == key % 64``, v = 1 and ``dO[q, d] = 1`` iff
    ``d == q % 64``. Then dP = 1 everywhere, ``delta[q] = O[q, q % 64]`` is
    inv times the kept share f of row q, ``ds = p · inv · (keep - f)`` and
    ``dq[q, d] = scale · ds[q, 64·live_tile + d]``: dq is positive exactly
    where the bit is set and negative where it is not (every row keeps
    some keys and drops some)."""
    b, h, l = READOUT
    rows = torch.arange(l, device=device)
    one_hot = (rows[:, None] % D == torch.arange(D, device=device)).to(dtype)
    in_tile = ((rows // KEY_TILE) == live_tile).to(dtype)[:, None]
    zeros = torch.zeros(b, h, l, D, dtype=dtype, device=device)
    ones = torch.ones(b, h, l, D, dtype=dtype, device=device)
    if kernel == "dkdv":
        return zeros, zeros.clone(), ones, (one_hot * in_tile).expand(b, h, l, D).contiguous()
    k = (one_hot * in_tile).expand(b, h, l, D).contiguous()
    return zeros, k, ones, one_hot.expand(b, h, l, D).contiguous()


def bwd_readout(dtype, live_tile: int, kernel: str, words, rate: float, device="cuda") -> torch.Tensor:
    """K1, then K3 and K2, on :func:`bwd_readout_inputs`: dv (``"dkdv"``)
    or dq (``"dq"``)."""
    q, k, v, do = bwd_readout_inputs(dtype, live_tile, kernel, device)
    out, lse = flash_mod.flash_forward(q, k, v, seed=words, rate=rate)
    dq, _, dv, _ = flash_mod.flash_backward(q, k, v, None, words, out, lse, do, rate=rate)
    return dv if kernel == "dkdv" else dq


def bwd_readout_mismatches(grad: torch.Tensor, words, live_tile: int, rate: float, kernel: str) -> int:
    """Elements where :func:`bwd_readout`'s gradient disagrees with
    keep_mask_reference: for dv, ``dv != 0`` against the bits of (query
    64·live_tile + d, key); for dq, ``dq > 0`` against the bits of (query,
    key 64·live_tile + d), plus every dq that is exactly 0."""
    g = grad.float().cpu()
    l = g.shape[2]
    bad = 0
    for bi in range(g.shape[0]):
        for hi in range(g.shape[1]):
            if kernel == "dkdv":
                want = flash_mod.keep_mask_reference(words, bi, hi, live_tile * KEY_TILE, 0, KEY_TILE, l, rate)
                bad += int(((g[bi, hi] != 0).float().T != want).sum())
            else:
                want = flash_mod.keep_mask_reference(words, bi, hi, 0, live_tile * KEY_TILE, l, KEY_TILE, rate)
                bad += int(((g[bi, hi] > 0).float() != want).sum() + (g[bi, hi] == 0).sum())
    return bad


def readout_mismatches(out: torch.Tensor, words, live_tile: int, rate: float) -> int:
    """Elements where ``(O != 0)`` is not ``keep_mask_reference``'s bit
    for the live key tile, plus, at rate 0.5, where ``32·O`` is not it."""
    o = out.float().cpu()
    bad = 0
    for bi in range(o.shape[0]):
        for hi in range(o.shape[1]):
            want = flash_mod.keep_mask_reference(words, bi, hi, 0, live_tile * KEY_TILE, o.shape[2], KEY_TILE, rate)
            bad += int(((o[bi, hi] != 0).float() != want).sum())
            if rate == 0.5:
                bad += int((o[bi, hi] * 32 != want).sum())
    return bad


def kernel_phase(seed: int) -> dict:
    """Phase 3: K1 against its plain version on dense and strided
    layouts, its refusals, then its times."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(b, L, True) for b in BUCKETS] + [(1, L, False), (8, 40, True), (2, 200, True)]
    bf16_err = 0.0
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, l, masked_row in cases:
            q, k, v, bias = attention_inputs(g, b, l, dtype, masked_row)
            out, lse = flash_mod.flash_forward(q, k, v, bias)
            torch.cuda.synchronize()
            ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias)
            check(out.dtype == dtype and out.shape == q.shape, f"K1 output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()), f"K1 non-finite at B={b} L={l} {dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            # lse of a fully masked row sits near -1e9, where an fp32 ulp is
            # 64: compare it relative to its size there.
            lse_diff = (lse - ref_lse).abs()
            lse_ok = bool((lse_diff <= 2e-5 + 2e-7 * ref_lse.abs()).all())
            print(f"K1 check {str(dtype):14s} B={b:3d} L={l:3d} max|O-ref|={err:.3e} (atol {atol}) max|lse-ref|={lse_diff.max().item():.3e}", flush=True)
            check(err <= atol, f"K1 disagrees with its plain version: {err} > {atol} at B={b} L={l} {dtype}")
            check(lse_ok, f"K1 lse disagrees at B={b} L={l} {dtype}")
            if dtype == torch.bfloat16 and l == L:
                bf16_err = max(bf16_err, err)
        # The layouts the model hands over: read through strides, no copy;
        # O is [B, L, H, D] storage.
        for layout in ("split", "fused"):
            for b, l in ((8, L), (BUCKETS[-1], L), (3, 40)):
                q, k, v, bias = attention_inputs(g, b, l, dtype, True, layout)
                check(not q.is_contiguous(), f"the {layout} layout gave dense q")
                out, lse = flash_mod.flash_forward(q, k, v, bias)
                torch.cuda.synchronize()
                ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias)
                err = (out.float() - ref.float()).abs().max().item()
                lse_ok = bool(((lse - ref_lse).abs() <= 2e-5 + 2e-7 * ref_lse.abs()).all())
                layout_ok = out.shape == q.shape and out.transpose(1, 2).is_contiguous()
                print(f"K1 check {str(dtype):14s} B={b:3d} L={l:3d} {layout:5s} views max|O-ref|={err:.3e} (atol {atol}) O stored [B,L,H,D] {layout_ok}", flush=True)
                check(err <= atol and lse_ok, f"K1 on {layout} views disagrees: {err} > {atol} (lse ok {lse_ok}) at B={b} L={l} {dtype}")
                check(layout_ok, f"K1's O is not [B, L, H, D] storage: strides {out.stride()}")
                if dtype == torch.bfloat16 and l == L:
                    bf16_err = max(bf16_err, err)
    # What the kernel does not take raises, and launches nothing.
    base = torch.zeros(2, H, L, 2 * D, dtype=torch.bfloat16, device="cuda")
    before = flash_mod.FWD_LAUNCHES
    for what, bad in (("misaligned rows", base[..., 1 : D + 1]), ("a strided last dim", base[..., ::2])):
        try:
            flash_mod.flash_forward(bad, bad, bad)
        except ValueError as e:
            print(f"K1 refuses {what}: {e}", flush=True)
        else:
            fail(f"K1 took {what}")
    check(flash_mod.FWD_LAUNCHES == before, "a refused layout launched K1")
    times = {}
    for b in BUCKETS:
        q, k, v, bias = attention_inputs(g, b, L, torch.bfloat16, True, "split")
        qd, kd, vd = (t.contiguous() for t in (q, k, v))
        mask_bf16 = bias.to(torch.bfloat16)
        t_k = time_ms(lambda: flash_mod.flash_forward(q, k, v, bias))
        t_d = time_ms(lambda: flash_mod.flash_forward(qd, kd, vd, bias))
        t_p = time_ms(lambda: flash_mod.flash_attention_reference(q, k, v, bias))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask_bf16))
        bound, bound_by = attention_bound(b, H, L, D, 2)
        times[b] = (t_k, t_p, t_l, bound, bound_by)
        print(f"K1 time B={b:3d} bf16 kernel_ms={t_k:.4f} (the model's views) dense_ms={t_d:.4f} plain_ms={t_p:.4f} library_ms(SDPA, same views)={t_l:.4f} bound_us={bound * 1e3:.1f} ({bound_by})", flush=True)
    t_k, t_p, t_l, bound, bound_by = times[BUCKETS[-1]]
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": f"{PORT}/csrc/flash_fwd.cu",
        "replaces": f"{JAX_FLASH}:135",
        "launches": None,
        "max_abs_err": bf16_err,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": t_l,
    }


def max_excess(a: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> tuple[float, bool]:
    """(max |a - ref|, whether every element is within atol + rtol·|ref|)."""
    diff = (a.float() - ref.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * ref.float().abs()).all())


def train_kernel_phase(seed: int) -> tuple[dict, dict, dict]:
    """Phase 4: K1 with dropout, K2 and K3 against their plain versions
    at the training shapes, then their times. Returns the kernels-line
    entries of K1 with dropout, K2 and K3."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cases = [(B_TRAIN, L, True, "dense"), (B_TRAIN, L, False, "dense"), (3, 40, True, "dense"),
             (2, 200, True, "dense"), (B_TRAIN, L, True, "split"), (3, 40, True, "fused")]
    bounds = {torch.float32: (2e-5, 1e-4, 0.0), torch.bfloat16: (2e-2, 1e-5, 8e-3)}
    errs = {"fwd": 0.0, "dkdv": 0.0, "dq": 0.0}
    for dtype, (fwd_atol, atol, rtol) in bounds.items():
        # The keep-mask read-out: K1's dropout coordinates, bit for bit.
        for rate in (RATE, 0.5):
            for live_tile in (0, 1):
                words = torch.randint(0, 2**32, (2,), generator=g, device="cuda", dtype=torch.int64)
                out, _ = flash_mod.flash_forward(*readout_inputs(dtype, live_tile), seed=words, rate=rate)
                bad = readout_mismatches(out, words, live_tile, rate)
                print(f"K1 keep-mask read-out {str(dtype):14s} rate={rate} live key tile {live_tile}: {bad} of {out.numel()} elements differ from keep_mask_reference", flush=True)
                check(bad == 0, f"K1's dropout mask is off at {bad} elements ({dtype}, rate {rate}, key tile {live_tile})")
                # The same bits out of K2's dv and K3's dq.
                for kernel, what in (("dkdv", "K2 dv"), ("dq", "K3 dq")):
                    grad = bwd_readout(dtype, live_tile, kernel, words, rate)
                    bad = bwd_readout_mismatches(grad, words, live_tile, rate, kernel)
                    print(f"{what} keep-mask read-out {str(dtype):14s} rate={rate} live tile {live_tile}: {bad} of {grad.numel()} elements differ from keep_mask_reference", flush=True)
                    check(bad == 0, f"{what}'s dropout mask is off at {bad} elements ({dtype}, rate {rate}, tile {live_tile})")
        for b, l, masked_row, layout in cases:
            q, k, v, bias = attention_inputs(g, b, l, dtype, masked_row, layout)
            do = torch.randn(b, H, l, D, generator=g, device="cuda").to(dtype)
            if layout != "dense":  # the model's dO: a view of O's [B, L, H, D] storage
                do = flash_mod.empty_out(q).copy_(do)
            words = torch.randint(0, 2**32, (2,), generator=g, device="cuda", dtype=torch.int64)
            out, lse = flash_mod.flash_forward(q, k, v, bias, seed=words, rate=RATE)
            ref, ref_lse = flash_mod.flash_attention_reference(q, k, v, bias, seed=words, rate=RATE)
            err = (out.float() - ref.float()).abs().max().item()
            lse_ok = bool(((lse - ref_lse).abs() <= 2e-5 + 2e-7 * ref_lse.abs()).all())
            check(err <= fwd_atol and lse_ok, f"K1 with dropout disagrees: {err} > {fwd_atol} (lse ok {lse_ok}) at B={b} L={l} {dtype}")
            if dtype == torch.bfloat16 and l == L:
                errs["fwd"] = max(errs["fwd"], err)
            for rate in (0.0, RATE):
                seed_words = words if rate else None
                qg, kg, vg, bg = (t.detach().clone().requires_grad_(True) for t in (q, k, v, bias))
                before = (flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES)
                o = flash_mod.FlashAttention.apply(qg, kg, vg, bg, seed_words, rate)
                o.backward(do)
                torch.cuda.synchronize()
                check((flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES) == (before[0] + 1, before[1] + 1),
                      "FlashAttention's backward did not launch K2 and K3")
                _, lse_k = flash_mod.flash_forward(q, k, v, bias, seed=seed_words, rate=rate)
                want = flash_mod.flash_backward_reference(q, k, v, bias, seed_words, o.detach(), lse_k, do, rate=rate)
                line = []
                for name, got, ref_g in (("dq", qg.grad, want[0]), ("dk", kg.grad, want[1]), ("dv", vg.grad, want[2])):
                    check(got.dtype == dtype and bool(torch.isfinite(got.float()).all()), f"{name} not finite / wrong dtype at B={b} L={l} {dtype}")
                    e, ok = max_excess(got, ref_g, atol, rtol)
                    check(ok, f"{name} disagrees with its plain version: max {e} (atol {atol}, rtol {rtol}) at B={b} L={l} rate={rate} {dtype}")
                    line.append(f"{name} {e:.3e}")
                    if dtype == torch.bfloat16 and l == L:
                        key = "dq" if name == "dq" else "dkdv"
                        errs[key] = max(errs[key], e)
                e, ok = max_excess(bg.grad, want[3], 1e-3, 0.0)
                check(ok, f"dbias disagrees: {e} at B={b} L={l} rate={rate} {dtype}")
                # Straight through flash_backward: the gradients as
                # [B, L, H, D] storage, no copy of dO, the same bits again.
                copies = flash_mod.BWD_DO_COPIES
                got = flash_mod.flash_backward(q, k, v, bias, seed_words, o.detach(), lse_k, do, rate=rate)
                again = flash_mod.flash_backward(q, k, v, bias, seed_words, o.detach(), lse_k, do, rate=rate)
                torch.cuda.synchronize()
                check(flash_mod.BWD_DO_COPIES == copies, f"the backward copied dO ({layout}, strides {do.stride()})")
                check(all(t.transpose(1, 2).is_contiguous() for t in got[:3]),
                      f"dq/dk/dv are not [B, L, H, D] storage: strides {[t.stride() for t in got[:3]]}")
                check(all(torch.equal(a, w) for a, w in zip(got, again)), f"repeated backward calls differ at B={b} L={l} rate={rate} {dtype}")
                check(all(torch.equal(a, w) for a, w in zip(got[:3], (qg.grad, kg.grad, vg.grad))),
                      f"flash_backward and autograd disagree at B={b} L={l} rate={rate} {dtype}")
                print(f"K2/K3 check {str(dtype):14s} B={b:2d} L={l:3d} {layout:5s} rate={rate} max|grad-ref|: {' '.join(line)} dbias {e:.3e}; K1 drop max|O-ref|={err:.3e}", flush=True)

    # Times at the training shape, bf16, dropout on.
    q, k, v, bias = attention_inputs(g, B_TRAIN, L, torch.bfloat16, True)
    do = torch.randn(B_TRAIN, H, L, D, generator=g, device="cuda").to(torch.bfloat16)
    words = torch.randint(0, 2**32, (2,), generator=g, device="cuda", dtype=torch.int64)
    mask_bf16 = bias.to(torch.bfloat16)
    qv, kv, vv = (split_heads(t.transpose(1, 2).reshape(B_TRAIN, L, H * D)) for t in (q, k, v))
    # The backward on the model's layout: q/k/v views of [B, L, H*D]
    # projections, dO a view of O's [B, L, H, D] storage.
    out, lse = flash_mod.flash_forward(qv, kv, vv, bias, seed=words, rate=RATE)
    do = flash_mod.empty_out(qv).copy_(do)
    copies = flash_mod.BWD_DO_COPIES
    x = flash_mod._BwdInputs(qv, kv, vv, bias, words, out, lse, do, RATE)
    check(flash_mod.BWD_DO_COPIES == copies, "the backward copied the model's dO")
    ref_args = (qv, kv, vv, bias, words, out, lse, do)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (qv, kv, vv))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask_bf16, dropout_p=RATE)
    t_lib_bwd = time_ms(lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do, retain_graph=True))
    fwd = {
        "name": "flash_fwd_dropout",
        "route": "cuda",
        "source": f"{PORT}/csrc/flash_fwd.cu",
        "replaces": f"{JAX_FLASH}:135",
        "launches": None,
        "max_abs_err": errs["fwd"],
        "ms": time_ms(lambda: flash_mod.flash_forward(qv, kv, vv, bias, seed=words, rate=RATE)),
        "plain_ms": time_ms(lambda: flash_mod.flash_attention_reference(qv, kv, vv, bias, seed=words, rate=RATE)),
    }
    t_dense = time_ms(lambda: flash_mod.flash_forward(q, k, v, bias, seed=words, rate=RATE))
    fwd["bound_ms"], fwd["bound_by"] = attention_bound(B_TRAIN, H, L, D, 2)
    fwd["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv, attn_mask=mask_bf16, dropout_p=RATE))
    print(f"K1 dropout time B={B_TRAIN} bf16 rate={RATE} kernel_ms={fwd['ms']:.4f} (the model's views) dense_ms={t_dense:.4f} plain_ms={fwd['plain_ms']:.4f} library_ms(SDPA, same views)={fwd['library_ms']:.4f} bound_us={fwd['bound_ms'] * 1e3:.1f} ({fwd['bound_by']})", flush=True)
    rows = [fwd]
    # K3 first: it writes the delta K2 reads.
    for name, kernel, launch, plain in (
        ("flash_bwd_dq", "dq", lambda: flash_mod.flash_bwd_dq(x),
         lambda: flash_mod.flash_dq_reference(*ref_args, rate=RATE)),
        ("flash_bwd_dkdv", "dkdv", lambda: flash_mod.flash_bwd_dkdv(x),
         lambda: flash_mod.flash_dkdv_reference(*ref_args, rate=RATE)),
    ):
        t_k, t_p = time_ms(launch), time_ms(plain)
        bound, bound_by = backward_bound(B_TRAIN, H, L, D, 2, kernel)
        print(f"{name} time B={B_TRAIN} bf16 rate={RATE} kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms(SDPA backward, both halves)={t_lib_bwd:.4f} bound_us={bound * 1e3:.1f} ({bound_by})", flush=True)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"{PORT}/csrc/flash_bwd.cu",
            "replaces": f"{JAX_FLASH}:{196 if kernel == 'dkdv' else 261}",
            "launches": None,
            "max_abs_err": errs[kernel],
            "ms": t_k,
            "plain_ms": t_p,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": t_lib_bwd,
        })
    # The kernels line lists K2 before K3.
    return rows[0], rows[2], rows[1]


def flow_records(seed: int, n: int) -> list[dict]:
    """CICIDS2017-shaped flow records (the template's ten columns)."""
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        pkts_f, pkts_b = int(rng.integers(1, 5000)), int(rng.integers(0, 5000))
        dur = int(rng.integers(1, 120_000_000))
        bytes_f = int(pkts_f * rng.integers(0, 1500))
        vals = [
            int(rng.choice([80, 443, 53, 22, int(rng.integers(1024, 65535))])),
            dur, pkts_f, pkts_b, bytes_f, int(pkts_b * rng.integers(0, 1500)),
            int(rng.integers(0, 1500)), int(rng.integers(0, 60)),
            round(bytes_f / dur * 1e6, 4), round((pkts_f + pkts_b) / dur * 1e6, 4),
        ]
        recs.append(dict(zip(FLOW_TEXT_COLUMNS, vals)))
    return recs


def publish(root: str, params: dict, round_id: int, cfg: ModelConfig) -> str:
    """Add ``params`` to the port's registry at ``root`` and promote them
    to serving through the ``registry`` verb; returns the artifact id."""
    aid = ModelRegistry(root).add(params, round_index=round_id, model_config=cfg)
    args = build_parser().parse_args(["registry", "promote", "--registry-dir", root, "--artifact", aid, "--to", "serving"])
    check(args.fn(args) == 0, f"registry promote {aid} failed")
    return aid


def path_phase(seed: int, device_name: str) -> int:
    """Phase 4: DistilBERT-base through infer-serve. Returns K1 launches."""
    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(
        vocab_size=len(tok.vocab), attention_impl="flash", compute_dtype="bfloat16"
    )
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    records = flow_records(seed, 49)
    texts = [flow_to_text(r) for r in records]
    enc = tok.batch_encode(texts, max_len=cfg.max_len)
    with tempfile.TemporaryDirectory() as reg:
        publish(reg, params, 1, cfg)
        args = build_parser().parse_args(
            ["infer-serve", "--registry-dir", reg, "--host", "127.0.0.1",
             "--port", "0", "--max-wait-ms", "10"]
        )
        server = build_server(args)
        check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
        replies: dict[int, dict] = {}
        latencies: list[float] = []
        lock = threading.Lock()
        errors: list[BaseException] = []

        def drive(rows):
            try:
                with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
                    for i in rows:
                        t0 = time.perf_counter()
                        if i % 2:
                            r = c.score(features=records[i])
                        else:
                            r = c.score(text=texts[i])
                        with lock:
                            latencies.append(time.perf_counter() - t0)
                            replies[i] = r
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        with server:  # warmup runs every bucket here
            flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
            batches0 = server.stats()["batches"]
            drive([0])  # a lone request: bucket 1
            workers = [threading.Thread(target=drive, args=(range(1 + t, 49, 16),)) for t in range(16)]
            t_burst = time.perf_counter()
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=300)
            burst_s = time.perf_counter() - t_burst
            launches = flash_mod.FWD_LAUNCHES
            check(flash_mod.FWD_DROPOUT_LAUNCHES == 0, "serving launched K1 with dropout")
            batches = server.stats()["batches"] - batches0
        check(not any(w.is_alive() for w in workers), "client threads hung")
        if errors:
            raise errors[0]
    check(sorted(replies) == list(range(49)), f"replies for {len(replies)}/49 requests")
    probs = np.array([replies[i]["prob"] for i in range(49)], np.float64)
    buckets = sorted({replies[i]["bucket"] for i in replies})
    print(f"path: {len(replies)} replies in {batches} batches, buckets {buckets}, K1 launches {launches}", flush=True)
    check(bool(np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()), "probs not finite in [0, 1]")
    check(len(buckets) >= 2, f"only bucket sizes {buckets} were hit")
    check(launches == cfg.n_layers * batches and batches > 0, f"K1 launched {launches} times for {batches} batches (want {cfg.n_layers} per batch)")

    # The same weights through the plain dot attention on the card.
    dot = ScoreEngine(dataclasses.replace(cfg, attention_impl="dot"), params, pad_id=tok.pad_id)
    want = dot.score(enc["input_ids"], enc["attention_mask"])[0]
    diff = float(np.abs(probs - want).max())
    print(f"path: max|prob_flash - prob_dot| = {diff:.3e} (bf16 atol 1e-2)", flush=True)
    check(diff <= 1e-2, f"flash path disagrees with the dot path: {diff}")
    # fp32 activations: the kernel's fp32 route against dot, tighter.
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    got32 = ScoreEngine(f32, params, pad_id=tok.pad_id).score(enc["input_ids"], enc["attention_mask"])[0]
    want32 = ScoreEngine(dataclasses.replace(f32, attention_impl="dot"), params, pad_id=tok.pad_id).score(
        enc["input_ids"], enc["attention_mask"]
    )[0]
    diff32 = float(np.abs(got32 - want32).max())
    print(f"path: fp32 max|prob_flash - prob_dot| = {diff32:.3e} (atol 1e-4)", flush=True)
    check(diff32 <= 1e-4, f"fp32 flash path disagrees with the dot path: {diff32}")
    lat = np.array(latencies) * 1e3
    print(
        f"path: {device_name}: burst of 48 flows in {burst_s:.3f} s = {48 / burst_s:.1f} flows/s; "
        f"client latency p50 {np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} ms",
        flush=True,
    )
    return launches


def train_phase(seed: int, card: str, ckpt_dir: str) -> tuple[dict[str, int], dict]:
    """Phase 6: ``local`` at full width on the card (``card``: its name and
    power limit, as nvidia-smi gives them), saving its state to
    ``ckpt_dir``. Returns each kernel's launches during it and what
    ``run_local`` returned."""
    with tempfile.TemporaryDirectory() as out_dir:
        args = build_parser().parse_args(
            ["local", "--preset", "distilbert", "--attention-impl", "flash",
             "--synthetic", "2400", "--epochs", "1", "--seed", str(seed),
             "--output-dir", out_dir, "--checkpoint-dir", ckpt_dir]
        )
        flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
        flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = flash_mod.BWD_DO_COPIES = 0
        res = run_local(args)
        torch.cuda.synchronize()
        launches = {
            "flash_fwd": flash_mod.FWD_LAUNCHES,
            "flash_fwd_dropout": flash_mod.FWD_DROPOUT_LAUNCHES,
            "flash_bwd_dkdv": flash_mod.DKDV_LAUNCHES,
            "flash_bwd_dq": flash_mod.DQ_LAUNCHES,
        }
        do_copies = flash_mod.BWD_DO_COPIES
        with open(res["metrics_csv"]) as f:
            header, values = f.read().strip().splitlines()
    cfg, state, trainer = res["config"], res["state"], res["trainer"]
    mcfg = cfg.model
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    check((mcfg.dim, mcfg.n_layers, mcfg.n_heads, mcfg.hidden_dim, mcfg.max_len) == (768, 6, 12, 3072, 128), f"not full width: {mcfg}")
    check(mcfg.compute_dtype == "bfloat16" and mcfg.attention_impl == "flash" and mcfg.attention_dropout == RATE, f"config {mcfg}")
    steps = state.step
    eval_batches = sum(-(-res[s]["n"] // cfg.data.eval_batch_size) for s in ("val", "test"))
    print(f"train: {steps} steps of bs{cfg.data.batch_size}, {eval_batches} eval batches, epoch losses {res['losses']}, launches {launches}, dO copies {do_copies}", flush=True)
    check(steps == 9, f"{steps} train steps, want 9 (2400 x 0.1 x 0.6 / 16)")
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == mcfg.n_layers * steps,
          f"K1-dropout/K2/K3 launches {launches} for {steps} steps")
    check(launches["flash_fwd"] == mcfg.n_layers * eval_batches, f"K1 (rate 0) launches {launches['flash_fwd']} for {eval_batches} eval batches")
    check(do_copies == 0, f"the backward copied dO {do_copies} times on the model's path")
    check(all(np.isfinite(res["losses"])), f"non-finite loss {res['losses']}")
    check(header == "Accuracy,Loss,Precision,Recall,F1-Score", f"metrics CSV header {header!r}")
    check(all(np.isfinite(float(v)) for v in values.split(",")), f"metrics CSV {values!r}")
    print(f"train: test metrics {header} = {values}", flush=True)
    check(os.listdir(ckpt_dir) == [str(steps)], f"checkpoint steps {os.listdir(ckpt_dir)}, want [{steps}]")
    nbytes = os.path.getsize(os.path.join(ckpt_dir, str(steps), STATE_FILE))
    print(f"train: {card}: saved step {steps} (params + Adam moments) in {res['save_seconds']:.3f} s, {nbytes / 1e6:.1f} MB", flush=True)

    # Steady-state rate: the epoch's batches 12 times again, after the fit.
    batches = list(trainer.epoch_batches(res["client"].train, 1, cfg.data.batch_size))
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    torch.cuda.synchronize()
    passes = []
    for _ in range(STEADY_PASSES):
        t0 = time.perf_counter()
        for b in batches:
            state, _ = trainer.train_step(state, b)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    n_steps = STEADY_PASSES * len(batches)
    dt = sum(passes)
    per_pass = [len(batches) * cfg.data.batch_size / p for p in passes]
    print(
        f"train: {card}: {n_steps * cfg.data.batch_size / dt:.1f} samples/s steady ({n_steps} steps of "
        f"bs{cfg.data.batch_size}, {dt / n_steps * 1e3:.3f} ms/step; per pass of {len(batches)} steps "
        f"min {min(per_pass):.1f} median {float(np.median(per_pass)):.1f} max {max(per_pass):.1f}); "
        f"the fit's first epoch {res['train_samples'] / res['train_seconds']:.1f} samples/s including its first step",
        flush=True,
    )

    # Parity on the card: one fp32 step, dropout off, flash against dot.
    batch = batches[0]
    ids, mask, labels = (torch.from_numpy(batch[k]).cuda() for k in ("input_ids", "attention_mask", "labels"))
    f32 = dataclasses.replace(mcfg, compute_dtype="float32", dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    params = init_params(f32, torch.Generator().manual_seed(seed))
    grads = {}
    for impl in ("flash", "dot"):
        c = dataclasses.replace(f32, attention_impl=impl)
        leaves = build_trainable_params(c, params, torch.device("cuda"))
        logits = torch.func.functional_call(model_skeleton(c), leaves, (ids, mask))
        grads[impl] = dict(zip(leaves, torch.autograd.grad(loss_fn(logits, labels), list(leaves.values()))))
    worst, ok = 0.0, True
    for name, g_dot in grads["dot"].items():
        e, good = max_excess(grads["flash"][name], g_dot, 1e-4, 1e-3)
        worst, ok = max(worst, e), ok and good
    print(f"train: fp32 grads flash vs dot over {len(grads['dot'])} leaves: max|diff| {worst:.3e} (atol 1e-4 + rtol 1e-3)", flush=True)
    check(ok, f"flash gradients disagree with the dot path: {worst}")

    # Learning: 20 steps on one fixed batch, dropout off.
    no_drop = dataclasses.replace(mcfg, dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    learner = Trainer(no_drop, TrainConfig(seed=seed), pad_id=trainer.pad_id, device="cuda")
    lstate = learner.init_state()
    losses = [float(learner.train_step(lstate, batch)[1]) for _ in range(20)]
    print(f"train: 20 steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"the loss did not fall: {losses}")
    return launches, res


def resume_check(seed: int, card: str, res: dict, ckpt_dir: str):
    """Lifecycle (a): 4 steps, save, warm start into a fresh ``Trainer``,
    5 more steps, dropout on, against 9 uninterrupted steps. Returns the
    resumed state (its weights are not phase 6's: another seed)."""
    cfg, tok_pad = res["config"], res["trainer"].pad_id
    train_cfg = dataclasses.replace(cfg.train, seed=seed + 1)
    trainer = Trainer(cfg.model, train_cfg, pad_id=tok_pad, device="cuda")
    batches = list(trainer.epoch_batches(res["client"].train, 0, cfg.data.batch_size))
    check(len(batches) == 9, f"{len(batches)} batches, want 9")
    flash_mod.FWD_DROPOUT_LAUNCHES = flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = 0
    whole = trainer.init_state()
    whole_losses = [trainer.train_step(whole, b)[1] for b in batches]
    part = trainer.init_state()
    losses = [trainer.train_step(part, b)[1] for b in batches[:4]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Checkpointer(ckpt_dir) as ckpt:
        ckpt.save(part.step, part)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(ckpt_dir, str(part.step), STATE_FILE))
    fresh = Trainer(cfg.model, train_cfg, pad_id=tok_pad, device="cuda")
    template = fresh.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed, step = maybe_warm_start(ckpt_dir, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(resumed is not None and step == 4 and resumed.step == 4, f"warm start gave step {step}")
    check(resumed.generator.device.type == "cuda", "the restored generator is not the card's")
    losses += [fresh.train_step(resumed, b)[1] for b in batches[4:]]
    torch.cuda.synchronize()
    launches = (flash_mod.FWD_DROPOUT_LAUNCHES, flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES)
    check(launches == (cfg.model.n_layers * 18,) * 3, f"K1-dropout/K2/K3 launches {launches} for 18 steps")
    got, want = torch.stack(losses).cpu().numpy(), torch.stack(whole_losses).cpu().numpy()
    loss_bits = np.array_equal(got, want)
    worst, ok, bits = 0.0, bool(np.allclose(got, want, atol=2e-6, rtol=1e-5)), loss_bits
    for n, t in whole.params.items():
        e, good = max_excess(resumed.params[n].detach(), t.detach(), 2e-6, 1e-5)
        worst, ok = max(worst, e), ok and good
        bits = bits and torch.equal(resumed.params[n], t)
    print(
        f"lifecycle: {card}: resume check, 4 steps + save ({save_s:.3f} s, {nbytes / 1e6:.1f} MB) + warm start "
        f"({restore_s:.3f} s) + 5 steps vs 9 steps, dropout {cfg.model.attention_dropout}: losses bit-equal {loss_bits}, "
        f"max|param diff| {worst:.3e} (atol 2e-6 + rtol 1e-5), everything bit-equal {bits}",
        flush=True,
    )
    check(ok, f"resumed training left the uninterrupted trajectory: max {worst}, losses {got} vs {want}")
    return resumed


def write_flows_csv(path: str, n: int, seed: int, **kw) -> None:
    """``n`` synthetic CICIDS2017 flows as a CSV with a Label column (NaN
    and ±inf cells unless ``kw`` turns them off)."""
    frame = make_synthetic_flows(n, seed=seed, **kw)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(frame))
        for i in range(n):
            w.writerow([frame[c][i] for c in frame])


def predict_check(card: str, csv_path: str, ckpt_dir: str, out: str) -> tuple[np.ndarray, int]:
    """Lifecycle (b): ``predict`` from the latest step of ``ckpt_dir``;
    its probs must equal ``Trainer.evaluate`` on the restored state bit
    for bit. Returns the probs and K1's launches during ``predict``."""
    flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
    pred = run_predict(build_parser().parse_args(
        ["predict", "--csv", csv_path, "--checkpoint-dir", ckpt_dir, "--output", out]
    ))
    torch.cuda.synchronize()
    launches = flash_mod.FWD_LAUNCHES
    check(flash_mod.FWD_DROPOUT_LAUNCHES == 0, "predict launched K1 with dropout")
    trainer, probs = pred["trainer"], pred["probs"]
    mcfg = trainer.model_cfg
    check(trainer.device.type == "cuda" and mcfg.attention_impl == "flash" and mcfg.dim == 768, f"predict ran {mcfg} on {trainer.device}")
    n = len(probs)
    batches = -(-n // 16)
    check(launches == mcfg.n_layers * batches, f"K1 launched {launches} times for {batches} predict batches")
    with Checkpointer(ckpt_dir) as ckpt:
        state = ckpt.restore(trainer.init_state())
    tok = default_tokenizer()
    enc = tok.batch_encode(frame_texts(load_flow_csv(csv_path)), max_len=mcfg.max_len)
    split = TokenizedSplit(enc["input_ids"], enc["attention_mask"], np.zeros(n, np.int32))
    want = trainer.evaluate(state.params, split, batch_size=16)["probs"]
    same = np.array_equal(probs, want)
    with open(out) as f:
        rows = f.read().strip().splitlines()
    print(
        f"lifecycle: {card}: predict {n} flows in {pred['seconds']:.3f} s = {n / pred['seconds']:.1f} flows/s "
        f"(tokenized rows in, probs out; K1 launches {launches}); probs bit-equal to Trainer.evaluate on the "
        f"restored state: {same}; {int(pred['predictions'].sum())} flagged",
        flush=True,
    )
    check(same, f"predict's probs differ from evaluate's: max {np.abs(probs - want).max()}")
    check(len(rows) == n + 1 and rows[0] == "prob_attack,prediction,label_name", "predictions CSV malformed")
    check(bool(np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()), "predict probs not finite in [0, 1]")
    return probs, launches


def score_texts(port: int, texts: list[str], threads: int = 8, auth_key: bytes | None = None) -> list[dict]:
    """Score ``texts`` through the port's client on ``threads`` connections."""
    replies: dict[int, dict] = {}
    errors: list[BaseException] = []

    def drive(rows):
        try:
            with ScoringClient("127.0.0.1", port, timeout=120, auth_key=auth_key) as c:
                for i in rows:
                    replies[i] = c.score(text=texts[i])
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    workers = [threading.Thread(target=drive, args=(range(t, len(texts), threads),)) for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    check(not any(w.is_alive() for w in workers), "client threads hung")
    if errors:
        raise errors[0]
    return [replies[i] for i in range(len(texts))]


def reload_check(card: str, what: str, argv: list[str], swap, texts: list[str], want: np.ndarray, old_round: int, new_round: int) -> int:
    """Lifecycle (c): ``infer-serve`` with ``argv`` serves ``old_round``;
    ``swap()`` finalizes a step or promotes an artifact; replies must then
    name ``new_round`` with probs within bf16's bound of ``want``
    (``predict`` on the new weights). Returns K1's launches while
    serving, after the warmup."""
    server = build_server(build_parser().parse_args(
        ["infer-serve", *argv, "--host", "127.0.0.1", "--port", "0", "--max-wait-ms", "5", "--reload-poll", "0.05"]
    ))
    check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
    with server:
        flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
        batches0 = server.stats()["batches"]
        before = score_texts(server.port, texts)
        check({r["round"] for r in before} == {old_round}, f"{what}: replies before the swap name rounds {sorted({r['round'] for r in before})}")
        swap()
        t_swap = time.perf_counter()
        with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
            while True:
                r = c.score(text=texts[0])
                if r["round"] == new_round:
                    break
                check(time.perf_counter() - t_swap < 60, f"{what}: no reply from round {new_round} within 60 s")
        first_s = time.perf_counter() - t_swap
        after = score_texts(server.port, texts)
        stats = server.stats()
        launches = flash_mod.FWD_LAUNCHES
        check(flash_mod.FWD_DROPOUT_LAUNCHES == 0, "serving launched K1 with dropout")
    probs = np.array([r["prob"] for r in after])
    diff = float(np.abs(probs - want).max())
    batches = stats["batches"] - batches0
    print(
        f"lifecycle: {card}: {what}: {stats['reloads']} reload; first reply from round {new_round} "
        f"{first_s:.3f} s after the swap; {len(after)} replies after it, max|prob - predict| {diff:.3e} "
        f"(bf16 atol 1e-2); K1 launches {launches} for {batches} batches",
        flush=True,
    )
    check(stats["reloads"] == 1 and {r["round"] for r in after} == {new_round}, f"{what}: replies after the swap name rounds {sorted({r['round'] for r in after})}")
    check(diff <= 1e-2, f"{what}: served probs differ from predict's by {diff}")
    n_layers = server.engine.model_cfg.n_layers
    check(launches == n_layers * batches, f"{what}: K1 launched {launches} times for {batches} batches")
    return launches


def lifecycle_phase(seed: int, card: str, res: dict, ckpt_dir: str, work: str) -> int:
    """Resume, predict and both hot reloads at full width on the card.
    Returns K1's rate-0 launches on these paths."""
    resumed = resume_check(seed, card, res, os.path.join(work, "resume"))
    csv_path = os.path.join(work, "flows.csv")
    write_flows_csv(csv_path, 512, seed)
    probs_old, k1_predict = predict_check(card, csv_path, ckpt_dir, os.path.join(work, "pred_old.csv"))
    step = int(os.listdir(ckpt_dir)[0])
    model_cfg = res["trainer"].model_cfg
    # The new weights: the resumed state, as a checkpoint step and an artifact.
    new_dir = os.path.join(work, "new")
    with Checkpointer(new_dir) as ckpt:
        ckpt.save(step + 1, resumed, meta={"kind": "local", "config": res["config"].to_dict()})
    probs_new, k1 = predict_check(card, csv_path, new_dir, os.path.join(work, "pred_new.csv"))
    k1_predict += k1
    texts = frame_texts(load_flow_csv(csv_path))[:48]
    # Stale weights must fail the served-probs check (atol 1e-2): on some
    # served text the old and new weights must differ by far more.
    gap = float(np.abs(probs_new[:48] - probs_old[:48]).max())
    print(f"lifecycle: max|prob_new - prob_old| over the {len(texts)} served texts {gap:.3e} (must exceed 10 x 1e-2)", flush=True)
    check(gap > 10 * 1e-2, f"the new weights score too like the old ones to tell a stale serve: {gap}")

    def finalize():  # a new step appears in the served directory
        os.rename(os.path.join(new_dir, str(step + 1)), os.path.join(ckpt_dir, str(step + 1)))

    k1_serve = reload_check(card, "infer-serve --checkpoint-dir", ["--checkpoint-dir", ckpt_dir], finalize,
                            texts, probs_new[:48], step, step + 1)
    root = os.path.join(work, "registry")
    with Checkpointer(ckpt_dir) as ckpt:
        publish(root, ckpt.restore_params(step=step), 1, model_cfg)
    new_aid = ModelRegistry(root).add(resumed.params, round_index=2, model_config=model_cfg)

    def promote():
        args = build_parser().parse_args(["registry", "promote", "--registry-dir", root, "--artifact", new_aid, "--to", "serving"])
        check(args.fn(args) == 0, "registry promote failed")

    k1_serve += reload_check(card, "infer-serve --registry-dir", ["--registry-dir", root], promote,
                             texts, probs_new[:48], 1, 2)
    print(f"lifecycle: K1 (rate 0) launches: predict {k1_predict}, serving around the reloads {k1_serve}", flush=True)
    return k1_predict + k1_serve


def _src_layer(name: str, stride: int) -> str:
    """The teacher leaf a student leaf starts from: layer i <- i * stride."""
    parts = name.split(".")
    if parts[1].startswith("layer_"):
        parts[1] = f"layer_{int(parts[1][len('layer_'):]) * stride}"
    return ".".join(parts)


def train_options_phase(seed: int, card: str, work: str) -> dict[str, int]:
    """Remat and gradient accumulation at full width: ``local --remat``
    with a ``--config`` file the port's own ``export-config`` wrote
    (``train.grad_accum_steps`` 3): 9 micro steps, Adam's count 3, K1 with
    dropout twice per layer a step (the forward and remat's recompute),
    K2 and K3 once. Then one step from one state with and without remat
    (loss and params compared), and the peak device memory of one bs64
    step each way. Returns the phase's launches."""
    args = build_parser().parse_args(["export-config", "--preset", "distilbert", "--attention-impl", "flash"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(args.fn(args) == 0, "export-config failed")
    d = json.loads(out.getvalue())
    d["train"]["grad_accum_steps"] = 3
    cfg_path = os.path.join(work, "accum.json")
    with open(cfg_path, "w") as f:
        json.dump(d, f)
    counts_zero()
    res = run_local(build_parser().parse_args(
        ["local", "--config", cfg_path, "--remat", "--synthetic", "2400", "--epochs", "1", "--seed", str(seed),
         "--output-dir", os.path.join(work, "opts")]
    ))
    local = counts_read()
    cfg, state, trainer = res["config"], res["state"], res["trainer"]
    mcfg = cfg.model
    L = mcfg.n_layers
    check((mcfg.dim, L, mcfg.max_len, mcfg.attention_impl, mcfg.compute_dtype) == (768, 6, 128, "flash", "bfloat16"), f"not full width: {mcfg}")
    check(mcfg.remat and cfg.train.grad_accum_steps == 3, f"remat {mcfg.remat}, grad_accum_steps {cfg.train.grad_accum_steps}")
    check((state.step, state.opt_state.count, state.mini_step) == (9, 3, 0),
          f"step {state.step}, Adam count {state.opt_state.count}, mini_step {state.mini_step}: want 9, 3, 0")
    eval_batches = sum(-(-res[s]["n"] // cfg.data.eval_batch_size) for s in ("val", "test"))
    print(f"train-options: local --remat --config (grad_accum_steps 3): {state.step} micro steps, Adam count "
          f"{state.opt_state.count}, epoch losses {res['losses']}, launches {local}", flush=True)
    check(local["flash_fwd_dropout"] == 2 * L * 9 and local["flash_bwd_dkdv"] == local["flash_bwd_dq"] == L * 9,
          f"K1-dropout/K2/K3 launches {local}: want {2 * L * 9}/{L * 9}/{L * 9} (remat recomputes K1)")
    check(local["flash_fwd"] == L * eval_batches, f"K1 (rate 0) launches {local['flash_fwd']} for {eval_batches} eval batches")
    check(flash_mod.BWD_DO_COPIES == 0, "the backward copied dO under remat")
    check(all(np.isfinite(res["losses"])), f"non-finite loss {res['losses']}")

    # One step from one state (dropout on, plain Adam), with and without remat.
    batches = list(trainer.epoch_batches(res["client"].train, 0, cfg.data.batch_size))
    steps = {}
    for remat in (False, True):
        t = Trainer(dataclasses.replace(mcfg, remat=remat), TrainConfig(seed=seed), pad_id=trainer.pad_id, device="cuda")
        st = t.init_state()
        st, loss = t.train_step(st, batches[0])
        steps[remat] = (loss.item(), st.params, st.generator.get_state())
    (l0, p0, g0), (l1, p1, g1) = steps[False], steps[True]
    worst, ok, bits = abs(l1 - l0), True, l1 == l0
    for n, t in p0.items():
        e, good = max_excess(p1[n].detach(), t.detach(), 2e-6, 1e-5)
        worst, ok, bits = max(worst, e), ok and good, bits and torch.equal(p1[n], t)
    print(f"train-options: {card}: one step with remat vs without, dropout {mcfg.attention_dropout}: loss {l1!r} vs "
          f"{l0!r}, largest difference {worst:.3e} (atol 2e-6 + rtol 1e-5), everything bit-equal {bits}, generator "
          f"states equal {torch.equal(g0, g1)}", flush=True)
    check(ok and abs(l1 - l0) <= 1e-6 and torch.equal(g0, g1), f"remat changed the step: {worst}")

    # Peak memory of one bs64 step.
    big = {k: np.concatenate([b[k] for b in batches[:4]]) for k in batches[0]}
    peaks = {}
    for remat in (False, True):
        t = Trainer(dataclasses.replace(mcfg, remat=remat), TrainConfig(seed=seed), pad_id=trainer.pad_id, device="cuda")
        st = t.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t.train_step(st, big)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(), before)
        del t, st
        torch.cuda.empty_cache()
    print(f"train-options: {card}: peak device memory of one bs{len(big['labels'])} step: without remat "
          f"{peaks[False][0] / 2**20:.1f} MiB, with remat {peaks[True][0] / 2**20:.1f} MiB (state before the step "
          f"{peaks[False][1] / 2**20:.1f} MiB)", flush=True)
    check(peaks[True][0] < peaks[False][0], "remat did not lower the step's peak memory")
    launches = counts_read()
    extra = {"flash_fwd_dropout": 2 * (L + 2 * L), "flash_bwd_dkdv": 2 * 2 * L, "flash_bwd_dq": 2 * 2 * L, "flash_fwd": 0}
    check(all(launches[k] == local[k] + extra[k] for k in extra), f"launches {launches} after {local} + {extra}")
    return launches


def distill_phase(seed: int, card: str, work: str, ckpt_dir: str, csv_path: str) -> dict[str, int]:
    """``distill`` at full width: a fresh 12-layer teacher trained 9 steps,
    then a 6-layer student distilled 9 steps (teacher at rate 0 in every
    step); student layer i is teacher layer 2i at init, bit for bit, and
    the teacher is unchanged after distillation; the card's KD loss held
    against a float64 one on the same logits. Then ``--teacher-checkpoint``
    (phase 6's) with ``--student-layers 3``, and ``predict`` on that
    student's checkpoint. Returns the phase's launches."""
    counts_zero()
    seen = {}
    orig = DistillTrainer.distill

    def watched(self, state, teacher_params, split, **kw):
        seen["teacher"] = {n: t.detach().clone() for n, t in teacher_params.items()}
        return orig(self, state, teacher_params, split, **kw)

    DistillTrainer.distill = watched
    try:
        res = run_distill(build_parser().parse_args(
            ["distill", "--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400", "--epochs", "1",
             "--seed", str(seed), "--output-dir", os.path.join(work, "distill"),
             "--checkpoint-dir", os.path.join(work, "student")]
        ))
    finally:
        DistillTrainer.distill = orig
    fresh = counts_read()
    tcfg, scfg = res["teacher_config"], res["config"].model
    check((tcfg.n_layers, scfg.n_layers, scfg.dim, scfg.attention_impl, scfg.compute_dtype) == (12, 6, 768, "flash", "bfloat16"),
          f"teacher {tcfg.n_layers} layers, student {scfg}")
    t_steps, s_steps = res["teacher_steps"], res["state"].step
    test_b = -(-len(res["client"].test) // 16)
    check(t_steps == s_steps == 9, f"teacher {t_steps} steps, student {s_steps}: want 9 each")
    same_init = all(torch.equal(t, seen["teacher"][_src_layer(n, 2)]) for n, t in res["initial"].items())
    unchanged = all(torch.equal(res["teacher_params"][n], t) for n, t in seen["teacher"].items())
    want = {
        "flash_fwd": 12 * s_steps + 12 * test_b + 6 * test_b,
        "flash_fwd_dropout": 12 * t_steps + 6 * s_steps,
        "flash_bwd_dkdv": 12 * t_steps + 6 * s_steps,
        "flash_bwd_dq": 12 * t_steps + 6 * s_steps,
    }
    print(f"distill: {card}: 12-layer teacher {t_steps} steps (losses {res['teacher_losses']}) -> 6-layer student "
          f"{s_steps} KD steps (losses {res['losses']}); student layer i == teacher layer 2i at init: {same_init}; "
          f"teacher unchanged: {unchanged}; test acc teacher {res['teacher_metrics']['Accuracy']:.4f} student "
          f"{res['student_metrics']['Accuracy']:.4f}; launches {fresh}, predicted {want}", flush=True)
    check(same_init, "the student did not start from every other teacher layer")
    check(unchanged, "distillation changed the teacher")
    check(fresh == want, f"distill launches {fresh}, predicted {want}")
    check(all(np.isfinite(res["losses"])) and all(np.isfinite(res["teacher_losses"])), "non-finite distill loss")

    # The KD loss on the card against float64 on the host, same logits.
    trainer, dcfg = res["trainer"], res["config"].distill
    batch = next(iter(trainer.epoch_batches(res["client"].train, 0, 16)))
    ids, mask, labels = (torch.from_numpy(batch[k]).cuda() for k in ("input_ids", "attention_mask", "labels"))
    with torch.no_grad():
        s_logits = trainer._logits(res["state"].params, ids, mask)
        t_logits = trainer.teacher_logits(res["teacher_params"], ids, mask)
        kd = distillation_loss(s_logits, t_logits, labels, temperature=dcfg.temperature, alpha=dcfg.alpha).item()
    s64, t64 = s_logits.double().cpu().numpy(), t_logits.double().cpu().numpy()
    y = batch["labels"]

    def log_softmax(x):
        m = x.max(-1, keepdims=True)
        return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))

    lt, ls = log_softmax(t64 / dcfg.temperature), log_softmax(s64 / dcfg.temperature)
    kl = (np.exp(lt) * (lt - ls)).sum(-1).mean()
    ce = -log_softmax(s64)[np.arange(len(y)), y].mean()
    ref = dcfg.alpha * dcfg.temperature**2 * kl + (1 - dcfg.alpha) * ce
    print(f"distill: {card}: KD loss on the card {kd!r}, float64 on the host {ref!r} (rtol 1e-5)", flush=True)
    check(abs(kd - ref) <= 1e-5 * abs(ref), f"the card's KD loss {kd} is off the float64 one {ref}")

    # --teacher-checkpoint: phase 6's model into 3 layers, then predict.
    counts_zero()
    student = os.path.join(work, "student3")
    res3 = run_distill(build_parser().parse_args(
        ["distill", "--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400", "--epochs", "1",
         "--seed", str(seed), "--teacher-checkpoint", ckpt_dir, "--student-layers", "3",
         "--output-dir", os.path.join(work, "distill3"), "--checkpoint-dir", student]
    ))
    ckpt3 = counts_read()
    check((res3["teacher_config"].n_layers, res3["config"].model.n_layers, res3["teacher_steps"]) == (6, 3, 0),
          f"teacher {res3['teacher_config'].n_layers} layers, student {res3['config'].model.n_layers}")
    same3 = all(torch.equal(t, res3["teacher_params"][_src_layer(n, 2)]) for n, t in res3["initial"].items())
    s3 = res3["state"].step
    want3 = {"flash_fwd": 6 * s3 + 6 * test_b + 3 * test_b, "flash_fwd_dropout": 3 * s3, "flash_bwd_dkdv": 3 * s3, "flash_bwd_dq": 3 * s3}
    check(same3 and ckpt3 == want3, f"--teacher-checkpoint: init from layers 0/2/4 {same3}, launches {ckpt3}, predicted {want3}")
    counts_zero()
    pred = run_predict(build_parser().parse_args(
        ["predict", "--csv", csv_path, "--checkpoint-dir", student, "--output", os.path.join(work, "pred3.csv")]
    ))
    predicted = counts_read()
    probs = pred["probs"]
    check(pred["model_config"].n_layers == 3 and bool(np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()),
          "predict on the 3-layer student: wrong depth or probs not in [0, 1]")
    check(predicted["flash_fwd"] == 3 * -(-len(probs) // 16), f"predict K1 launches {predicted}")
    print(f"distill: {card}: --teacher-checkpoint (6 layers) -> 3-layer student: {s3} steps, init from teacher "
          f"layers 0/2/4 {same3}, launches {ckpt3}; predict on its checkpoint: {len(probs)} flows, "
          f"{int(pred['predictions'].sum())} flagged, K1 launches {predicted['flash_fwd']}", flush=True)
    return {k: fresh[k] + ckpt3[k] + predicted[k] for k in fresh}


def migrate_phase(seed: int, card: str, work: str, ckpt_dir: str, csv_path: str) -> dict[str, int]:
    """The pretrained start and the way back out at full width:
    ``export-hf`` of phase 6's checkpoint directory; ``predict --hf-dir``
    against ``predict --checkpoint-dir``; a reference-style ``.pth`` from
    the export, ``predict --hf-dir --pth`` and ``export-hf --pth`` (the
    same ``model.safetensors`` bytes); ``local --hf-dir`` (9 steps); and
    ``infer-serve --hf-dir --pth`` answering 32 flows within bf16's bound
    of ``predict``; then the other ``--hf-dir`` verbs (:func:`hf_verbs_check`).
    Returns the phase's launches (K4's under ``fold``)."""
    flags = ["--preset", "distilbert", "--attention-impl", "flash"]
    hf, hf2 = os.path.join(work, "hf"), os.path.join(work, "hf2")
    counts_zero()
    t0 = time.perf_counter()
    exp = run_export_hf(build_parser().parse_args(["export-hf", *flags, "--checkpoint-dir", ckpt_dir, "--out", hf]))
    export_s = time.perf_counter() - t0
    check(sorted(os.listdir(hf)) == ["config.json", "model.safetensors", "vocab.txt"] and hf_dir_has_head(hf), f"export wrote {os.listdir(hf)}")

    def predict(*argv):
        return run_predict(build_parser().parse_args(["predict", *flags, "--csv", csv_path, *argv]))

    p_ckpt = predict("--checkpoint-dir", ckpt_dir, "--output", os.path.join(work, "m_ckpt.csv"))
    p_hf = predict("--hf-dir", hf, "--output", os.path.join(work, "m_hf.csv"))
    diff = float(np.abs(p_hf["probs"] - p_ckpt["probs"]).max())
    same_cfg = p_hf["model_config"] == p_ckpt["model_config"]
    pth = os.path.join(work, "client1_model.pth")
    torch.save({k: torch.from_numpy(v) for k, v in load_safetensors(os.path.join(hf, "model.safetensors")).items()}, pth)
    p_pth = predict("--hf-dir", hf, "--pth", pth, "--output", os.path.join(work, "m_pth.csv"))
    diff_pth = float(np.abs(p_pth["probs"] - p_hf["probs"]).max())
    run_export_hf(build_parser().parse_args(["export-hf", *flags, "--hf-dir", hf, "--pth", pth, "--out", hf2]))
    with open(os.path.join(hf, "model.safetensors"), "rb") as a, open(os.path.join(hf2, "model.safetensors"), "rb") as b:
        same_bytes = a.read() == b.read()
    nbytes = os.path.getsize(os.path.join(hf, "model.safetensors"))
    print(f"migrate: {card}: export-hf of {ckpt_dir} ({len(exp['tensors'])} tensors, {nbytes / 1e6:.1f} MB, "
          f"{export_s:.3f} s); predict --hf-dir vs --checkpoint-dir on {len(p_hf['probs'])} flows: max|diff| "
          f"{diff:.3e} (same model config {same_cfg}); predict --hf-dir --pth vs --hf-dir: max|diff| {diff_pth:.3e}; "
          f"export-hf --pth gives the same model.safetensors bytes: {same_bytes}", flush=True)
    a, b = dataclasses.asdict(p_hf["model_config"]), dataclasses.asdict(p_ckpt["model_config"])
    check(same_cfg, f"--hf-dir resolves another model: {[(k, a[k], b[k]) for k in a if a[k] != b[k]]}")
    check(diff <= 1e-6 and diff_pth <= 1e-6, f"the migrated model scores differently: {diff}, {diff_pth}")
    check(same_bytes, "export-hf --pth wrote other bytes than the checkpoint's export")
    L = p_hf["model_config"].n_layers
    check(counts_read()["flash_fwd"] == 3 * L * -(-len(p_hf["probs"]) // 16), "predict K1 launches")

    res = run_local(build_parser().parse_args(
        ["local", *flags, "--hf-dir", hf, "--synthetic", "2400", "--epochs", "1", "--seed", str(seed),
         "--output-dir", os.path.join(work, "m_local")]
    ))
    steps = res["state"].step
    check(steps == 9 and all(np.isfinite(res["losses"])), f"local --hf-dir: {steps} steps, losses {res['losses']}")
    eval_b = sum(-(-res[s]["n"] // 16) for s in ("val", "test"))

    server = build_server(build_parser().parse_args(
        ["infer-serve", *flags, "--hf-dir", hf, "--pth", pth, "--host", "127.0.0.1", "--port", "0", "--max-wait-ms", "5"]
    ))
    check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
    texts = frame_texts(load_flow_csv(csv_path))[:32]
    trained = counts_read()
    want = {
        "flash_fwd": 3 * L * -(-len(p_hf["probs"]) // 16) + L * eval_b,
        "flash_fwd_dropout": L * steps, "flash_bwd_dkdv": L * steps, "flash_bwd_dq": L * steps,
    }
    check(trained == want, f"migrate launches {trained} through local --hf-dir, predicted {want}")
    with server:  # the warmup (one batch a bucket) runs on entry
        warm = counts_read()
        batches0 = server.stats()["batches"]
        replies = score_texts(server.port, texts)
        batches = server.stats()["batches"] - batches0
        launches = counts_read()
    served = np.array([r["prob"] for r in replies])
    sdiff = float(np.abs(served - p_pth["probs"][:32]).max())
    print(f"migrate: {card}: local --hf-dir {steps} steps, losses {res['losses']}, test acc "
          f"{res['test']['Accuracy']:.4f}; infer-serve --hf-dir --pth: {len(replies)} replies in {batches} batches, "
          f"max|prob - predict| {sdiff:.3e} (bf16 atol 1e-2); launches {launches}", flush=True)
    check(sdiff <= 1e-2, f"infer-serve --hf-dir --pth differs from predict by {sdiff}")
    check(launches["flash_fwd"] - warm["flash_fwd"] == L * batches and launches["flash_fwd_dropout"] == trained["flash_fwd_dropout"],
          f"serving K1 launches {launches['flash_fwd'] - warm['flash_fwd']} for {batches} batches")
    total = {**launches, "fold": 0}
    add_launches(total, hf_verbs_check(seed, card, work, hf, pth))
    return total


def native_wire_check(card: str, upload: dict) -> None:
    """The wire's native byte path on a full-width upload: built and
    active, its CRC equal to zlib's, its bf16 pack equal to the numpy
    twin's, and the host seconds of a bf16 upload's encode both ways."""
    check(wire_native.have_native(), f"the native wire is not active: {native.build_error('fedwire.cpp')}")
    blob = wire.encode(upload, meta={"client_id": 0})
    t0 = time.perf_counter()
    crc = wire_native.crc32(blob)
    crc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = zlib.crc32(blob)
    zlib_s = time.perf_counter() - t0
    check(crc == want, f"native crc {crc:#010x} != zlib's {want:#010x}")
    flat = wire.flatten_params(upload)
    same_pack = all(np.array_equal(wire_native.pack_bf16(v), wire_native.pack_bf16_numpy(v)) for v in flat.values() if v.dtype == np.float32)
    check(same_pack, "the native bf16 pack differs from the numpy twin's")
    t0 = time.perf_counter()
    nat = wire.encode(upload, meta={"client_id": 0}, compression="bf16")
    nat_s = time.perf_counter() - t0
    lib = wire_native.lib
    wire_native.lib = lambda: None
    try:
        t0 = time.perf_counter()
        ref = wire.encode(upload, meta={"client_id": 0}, compression="bf16")
        np_s = time.perf_counter() - t0
    finally:
        wire_native.lib = lib
    check(nat == ref, "the bf16 upload's bytes differ between the native and numpy paths")
    print(f"rounds: {card}: native wire active; upload of {len(blob) / 1e6:.1f} MB: crc {crc:#010x} == zlib's, "
          f"host seconds native {crc_s:.4f} vs zlib {zlib_s:.4f}; bf16 pack == numpy over {len(flat)} leaves; "
          f"bf16 upload encode ({len(nat) / 1e6:.1f} MB) host seconds native {nat_s:.4f} vs numpy {np_s:.4f} "
          "(the card's machine's host CPU)", flush=True)



def counts_zero() -> None:
    flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
    flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = flash_mod.BWD_DO_COPIES = 0


def counts_read() -> dict[str, int]:
    torch.cuda.synchronize()
    return {
        "flash_fwd": flash_mod.FWD_LAUNCHES,
        "flash_fwd_dropout": flash_mod.FWD_DROPOUT_LAUNCHES,
        "flash_bwd_dkdv": flash_mod.DKDV_LAUNCHES,
        "flash_bwd_dq": flash_mod.DQ_LAUNCHES,
    }


class FedWatch:
    """Wraps the trainer's round boundary and lockstep step while the
    federated phase runs: before each aggregation it copies the stacked
    params on the card, after it checks that every client row equals row
    0 and keeps row 0; at the first step where a client's batch is all
    padding it copies that client's params, moments and (with
    accumulation) window and checks them after the step. The copies stay on the card (a few ms inside the
    timed aggregate); the fp64 comparison runs after the invocation."""

    def __init__(self):
        self.aggs: list[tuple] = []
        self.gated: tuple | None = None
        self._orig = (FederatedTrainer.round_aggregate, FederatedTrainer.train_step)

    def __enter__(self):
        agg, step = self._orig
        watch = self

        def round_aggregate(trainer, state, **kw):
            pre = {n: p.detach().clone() for n, p in state.params.items()}
            out = agg(trainer, state, **kw)
            rows_equal = all(torch.equal(p[c], p[0]) for p in out.params.values() for c in range(1, p.shape[0]))
            watch.aggs.append((pre, {n: p[0].detach().clone() for n, p in out.params.items()}, kw.get("weights"), rows_equal))
            return out

        def train_step(trainer, state, batch, anchor=None):
            idle = [c for c in range(trainer.C) if "valid" in batch and not batch["valid"][c].any()]
            if not idle or watch.gated is not None:
                return step(trainer, state, batch, anchor)
            c = idle[0]
            opt = state.opt_state
            groups = (state.params, opt.mu, opt.nu) + (() if opt.acc is None else (opt.acc,))
            before = [{n: t[c].detach().clone() for n, t in d.items()} for d in groups]
            count, mini = opt.count[c], None if opt.mini_step is None else opt.mini_step[c]
            out = step(trainer, state, batch, anchor)
            same = all(
                torch.equal(now[n][c], t)
                for now, was in zip(groups, before)
                for n, t in was.items()
            ) and opt.count[c] == count and (mini is None or opt.mini_step[c] == mini)
            watch.gated = (c, state.step, same)
            return out

        FederatedTrainer.round_aggregate, FederatedTrainer.train_step = round_aggregate, train_step
        return self

    def __exit__(self, *exc):
        FederatedTrainer.round_aggregate, FederatedTrainer.train_step = self._orig

    def check_aggregates(self, card: str) -> None:
        """Every aggregation this invocation made: rows bit-equal, and row
        0 within atol 1e-6 of the fp64 weighted mean of the copies."""
        for pre, post0, weights, rows_equal in self.aggs:
            check(rows_equal, "after the aggregation some client row differs from row 0")
            w = np.ones(FED_CLIENTS) if weights is None else np.asarray(weights, np.float64)
            w = w / w.sum()
            worst = 0.0
            for n, x in pre.items():
                mean = np.tensordot(w, x.cpu().numpy().astype(np.float64), axes=1)
                worst = max(worst, float(np.abs(post0[n].cpu().numpy() - mean).max()))
            print(f"federated: {card}: aggregate: every row bit-equal to row 0: {rows_equal}; max|row 0 - fp64 weighted mean| {worst:.3e} (atol 1e-6)", flush=True)
            check(worst <= 1e-6, f"the aggregate is {worst} off the fp64 weighted mean")
        self.aggs.clear()


def eval_client_batches(prepared) -> int:
    """Client-batches one evaluation over ``prepared`` runs: each client's
    slices that hold a valid row (the stacked eval skips all-padding
    ones)."""
    bs, valid = prepared.batch_size, prepared.valid
    return int(sum(valid[:, i : i + bs].any(axis=1).sum() for i in range(0, valid.shape[1], bs)))


def federated_invocation(seed: int, card: str, rounds: int, ckpt_dir: str, reg_dir: str, out_dir: str) -> tuple[dict, dict[str, int]]:
    """One ``federated`` run at full width through the parser, with the
    launch counts and the checks of :class:`FedWatch`. Returns what
    ``run_federated`` returned and the launches of this run."""
    args = build_parser().parse_args(
        ["federated", "--preset", "distilbert", "--attention-impl", "flash", *FED_ARGS,
         "--rounds", str(rounds), "--seed", str(seed), "--checkpoint-dir", ckpt_dir,
         "--registry-dir", reg_dir, "--output-dir", out_dir]
    )
    torch.cuda.reset_peak_memory_stats()
    with FedWatch() as watch:
        counts_zero()
        t0 = time.perf_counter()
        res = run_federated(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts_read()
        do_copies = flash_mod.BWD_DO_COPIES
    peak = torch.cuda.max_memory_allocated()
    cfg, trainer = res["config"], res["trainer"]
    mcfg = cfg.model
    check(trainer.device.type == "cuda", f"federated trainer on {trainer.device}")
    check((mcfg.dim, mcfg.n_layers, mcfg.n_heads, mcfg.hidden_dim, mcfg.max_len) == (768, 6, 12, 3072, 128), f"not full width: {mcfg}")
    check(mcfg.compute_dtype == "bfloat16" and mcfg.attention_impl == "flash" and mcfg.attention_dropout == RATE, f"config {mcfg}")
    n_rows = [int(n) for n in res["stacked_train"].n_rows]
    bs = cfg.data.batch_size
    ran = len(res["history"])
    client_steps = ran * cfg.train.epochs_per_round * sum(-(-n // bs) for n in n_rows)
    prepare = trainer.prepare_eval
    val_cb = eval_client_batches(prepare([c.val for c in res["clients"]]))
    test_cb = eval_client_batches(prepare([c.test for c in res["clients"]]))
    eval_cb = ran * 2 * (val_cb + test_cb) + test_cb  # local + aggregated val/test a round, then the final test
    print(
        f"federated: {card}: rounds {res['start_round'] + 1}..{cfg.fed.rounds} of {FED_CLIENTS} clients, train rows {n_rows} "
        f"(val {[len(c.val) for c in res['clients']]}, test {[len(c.test) for c in res['clients']]}); "
        f"{client_steps} client-steps, {eval_cb} eval client-batches; launches {launches}, dO copies {do_copies}; "
        f"wall {wall:.3f} s; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB",
        flush=True,
    )
    check(max(n_rows) >= 2 * min(n_rows) and -(-min(n_rows) // bs) < -(-max(n_rows) // bs),
          f"client rows {n_rows}: want a 2x spread and an idle tail")
    for row in ("flash_fwd_dropout", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(launches[row] == mcfg.n_layers * client_steps, f"{row} launched {launches[row]} times for {client_steps} client-steps")
    check(launches["flash_fwd"] == mcfg.n_layers * eval_cb, f"K1 (rate 0) launched {launches['flash_fwd']} times for {eval_cb} eval client-batches")
    check(do_copies == 0, f"the backward copied dO {do_copies} times")
    samples = cfg.train.epochs_per_round * sum(n_rows)  # every real row once an epoch
    for h in res["history"]:
        s, r = h.seconds, h.round + 1
        check(np.isfinite(h.epoch_losses).all(), f"round {r}: non-finite loss {h.epoch_losses}")
        print(
            f"federated: {card}: round {r}: fit {s['fit']:.3f} s ({samples / s['fit']:.1f} samples/s over all "
            f"clients, {samples} samples), local eval {s['local_eval']:.3f} s, aggregate {s['aggregate']:.3f} s, "
            f"aggregated eval {s['aggregated_eval']:.3f} s, save {s['save']:.3f} s; epoch losses {np.round(h.epoch_losses, 4).tolist()}; "
            f"aggregated test acc {[round(m['Accuracy'], 2) for m in h.aggregated_metrics]}",
            flush=True,
        )
    watch.check_aggregates(card)
    check(len(res["artifacts"]) == ran, f"{len(res['artifacts'])} registry artifacts for {ran} rounds")
    if ran:
        check(watch.gated is not None, "no lockstep step gated an idle client")
        c, step, same = watch.gated
        print(f"federated: client {c} idled through step {step}: params, moments and count unchanged {same}", flush=True)
        check(same, f"client {c}'s state changed on a step it idled through")
    for path in res["metrics_csvs"]:
        with open(path) as f:
            header, values = f.read().strip().splitlines()
        check(header == "Accuracy,Loss,Precision,Recall,F1-Score", f"{path} header {header!r}")
        check(all(np.isfinite(float(v)) for v in values.split(",")), f"{path} {values!r}")
    return res, launches


def federated_phase(seed: int, card: str, work: str) -> dict[str, int]:
    """The ``federated`` verb at full width, 4 clients, ragged: round 1 as
    one invocation, round 2 as a second that resumes from its checkpoint,
    with ``infer-serve --checkpoint-dir`` serving round 1 and swapping to
    round 2 when the resumed run finalizes it. Returns each kernel's
    launches on these paths."""
    ckpt_dir, reg_dir, out_dir = (os.path.join(work, d) for d in ("fed_ckpt", "fed_registry", "fed_out"))
    csv_path = os.path.join(work, "fed_flows.csv")
    write_flows_csv(csv_path, 256, seed + 3)
    texts = frame_texts(load_flow_csv(csv_path))[:48]
    total = {k: 0 for k in ("flash_fwd", "flash_fwd_dropout", "flash_bwd_dkdv", "flash_bwd_dq")}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    res1, launches = federated_invocation(seed, card, 1, ckpt_dir, reg_dir, out_dir)
    add(launches)
    check(sorted(os.listdir(ckpt_dir)) == ["1"], f"checkpoint rounds {os.listdir(ckpt_dir)}")
    counts_zero()
    probs1 = run_predict(build_parser().parse_args(
        ["predict", "--csv", csv_path, "--checkpoint-dir", ckpt_dir, "--output", os.path.join(work, "fed_p1.csv")]
    ))["probs"]
    add(counts_read())
    del res1
    server = build_server(build_parser().parse_args(
        ["infer-serve", "--checkpoint-dir", ckpt_dir, "--host", "127.0.0.1", "--port", "0",
         "--max-wait-ms", "5", "--reload-poll", "0.05"]
    ))
    check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
    with server:
        counts_zero()
        before = score_texts(server.port, texts)
        add(counts_read())
        check({r["round"] for r in before} == {1}, f"replies before the resume name rounds {sorted({r['round'] for r in before})}")
        res2, launches = federated_invocation(seed, card, 2, ckpt_dir, reg_dir, out_dir)
        add(launches)
        check(res2["start_round"] == 1 and len(res2["history"]) == 1, f"the second invocation started at round {res2['start_round']}")
        t_fin = time.perf_counter()
        counts_zero()
        with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
            while c.score(text=texts[0])["round"] != 2:
                check(time.perf_counter() - t_fin < 60, "no reply from round 2 within 60 s of the resumed run's end")
        first_s = time.perf_counter() - t_fin
        after = score_texts(server.port, texts)
        add(counts_read())
        stats = server.stats()
    check(stats["reloads"] == 1 and {r["round"] for r in after} == {2}, f"replies after the swap name rounds {sorted({r['round'] for r in after})}")
    counts_zero()
    pred2 = run_predict(build_parser().parse_args(
        ["predict", "--csv", csv_path, "--checkpoint-dir", ckpt_dir, "--output", os.path.join(work, "fed_p2.csv")]
    ))
    add(counts_read())
    probs2 = pred2["probs"]
    check(pred2["model_config"].dim == 768 and pred2["trainer"].device.type == "cuda", "predict did not run the full-width model on the card")

    # predict on round 2 against the trainer's own stacked evaluation.
    tok = default_tokenizer()
    frame = load_flow_csv(csv_path)
    enc = tok.batch_encode(frame_texts(frame), max_len=res2["config"].model.max_len)
    split = TokenizedSplit(enc["input_ids"], enc["attention_mask"], np.zeros(len(probs2), np.int32))
    rows = res2["trainer"].evaluate_clients(res2["state"].params, [split] * FED_CLIENTS, collect_probs=True)
    same = np.array_equal(probs2, rows[0]["probs"])
    print(f"federated: {card}: predict on round 2 ({len(probs2)} flows) bit-equal to evaluate_clients row 0: {same}", flush=True)
    check(same, f"predict differs from evaluate_clients row 0 by {np.abs(probs2 - rows[0]['probs']).max()}")

    gap = float(np.abs(probs2[:48] - probs1[:48]).max())
    served = np.array([r["prob"] for r in after])
    diff = float(np.abs(served - probs2[:48]).max())
    print(
        f"federated: {card}: infer-serve --checkpoint-dir: first reply from round 2 {first_s:.3f} s "
        f"after the resumed run returned (it swapped while the run's final evaluation ran); max|served - predict| {diff:.3e} (bf16 atol 1e-2); "
        f"max|prob_round2 - prob_round1| over the {len(texts)} served texts {gap:.3e} (must exceed 10 x 1e-2)",
        flush=True,
    )
    check(diff <= 1e-2, f"served probs differ from round 2's predict by {diff}")
    check(gap > 10 * 1e-2, f"round 2 scores too like round 1 to tell a stale serve: {gap}")

    reg = ModelRegistry(reg_dir)
    manifests = sorted((reg.manifest(a) for a in os.listdir(os.path.join(reg_dir, "artifacts")) if not a.startswith(".")), key=lambda m: m["round"])
    print(f"federated: registry: {[(m['round'], m['id'], m.get('extra')) for m in manifests]}", flush=True)
    check([m["round"] for m in manifests] == [1, 2], f"registry rounds {[m['round'] for m in manifests]}")
    check(all(m.get("extra") == {"tier": "mesh", "clients": FED_CLIENTS} for m in manifests), "registry extra")
    del res2, rows
    print(f"federated: launches on these paths {total}", flush=True)
    return total


def numpy_fold(leaves: list[np.ndarray], weights: np.ndarray) -> np.ndarray:
    """The JAX package's ``fold_naive`` on the host: ``acc += float32(w) * x``."""
    acc = np.zeros(leaves[0].shape, np.float32)
    for a, w in zip(leaves, weights):
        acc += np.float32(w) * a
    return acc


def fold_bound(k: int, n: int) -> tuple[float, str]:
    """Least time (ms) for one fold: K leaves read once, the result
    written once, fp32; 2·K·n fp32 operations are far below the card's
    rate, so bytes bound it."""
    return (k + 1) * n * 4 / HBM_BYTES_PER_S * 1e3, "bytes"


def fold_kernel_phase(seed: int, card: str) -> dict:
    """Phase 7: K4 bit-exact against its plain version and numpy, then its
    times on the word-embedding leaf. Returns its kernels-line entry."""
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    cases = [(k, EMBED_N, False) for k in (1, 2, 8)]
    cases += [(k, n, False) for k in (1, 2, 8) for n in (1, 3, 768, 32769)]
    cases += [(k, n, True) for k in (2, 8) for n in (4099, 32768)]
    for k, n, subnormal in cases:
        if subnormal:  # ±1e-40, subnormal in fp32
            x = (torch.randint(0, 2, (k, n), generator=g, device="cuda") * 2 - 1).float() * 1e-40
        else:
            scales = 10.0 ** torch.randint(-4, 5, (k, 1), generator=g, device="cuda").float()
            x = torch.randn(k, n, generator=g, device="cuda") * scales
        w = torch.rand(k, generator=g, device="cuda") + 0.05
        got = fold_mod.fold_stacked(x, w)
        torch.cuda.synchronize()
        plain = fold_mod.fold_reference(list(x), w)
        host = numpy_fold(list(x.cpu().numpy()), w.cpu().numpy())
        same = torch.equal(got, plain) and np.array_equal(got.cpu().numpy(), host)
        again = torch.equal(fold_mod.fold_stacked(x, w), got)
        if subnormal:
            check(bool(((host != 0) & (np.abs(host) < np.finfo(np.float32).tiny)).any()), "the subnormal case made no subnormal result")
        if n >= EMBED_N or n <= 3 or subnormal:
            print(f"K4 check K={k} n={n:9d}{' subnormal' if subnormal else ''}: array_equal plain {torch.equal(got, plain)} numpy {np.array_equal(got.cpu().numpy(), host)} repeat {again}", flush=True)
        check(same and again, f"K4 is not bit-exact at K={k} n={n} subnormal={subnormal}")
        del x, got, plain
    entry = None
    for k in (2, 8):
        x = torch.randn(k, EMBED_N, generator=g, device="cuda")
        w = torch.rand(k, generator=g, device="cuda") + 0.05
        xt = x.t()
        t_k = time_ms(lambda: fold_mod.fold_stacked(x, w))
        t_p = time_ms(lambda: fold_mod.fold_reference(list(x), w))
        t_l = time_ms(lambda: torch.mv(xt, w))
        bound, bound_by = fold_bound(k, EMBED_N)
        print(f"K4 time K={k} n={EMBED_N} fp32 {card}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms(torch.mv)={t_l:.4f} bound_ms={bound:.4f} ({bound_by}); {(k + 1) * EMBED_N * 4 / (t_k * 1e-3) / 1e9:.1f} GB/s", flush=True)
        if k == 2:
            entry = {
                "name": "fold",
                "route": "cuda",
                "source": f"{PORT}/csrc/fold.cu",
                "replaces": f"{JAX_FOLD}:138",
                "launches": None,
                "max_abs_err": 0.0,
                "ms": t_k,
                "plain_ms": t_p,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": t_l,
            }
        del x, xt
    # The aggregator's path on one leaf: host leaves in, host result out.
    leaves = [np.random.default_rng(seed + i).standard_normal(EMBED_N, dtype=np.float32) for i in range(2)]
    weights = [np.float32(0.5)] * 2
    times: dict = {}
    for _ in range(3):
        times.clear()
        t0 = time.perf_counter()
        out = fold_mod.fold_ordered(leaves, weights, device="cuda", times=times)
        wall = time.perf_counter() - t0
    check(np.array_equal(out, numpy_fold(leaves, weights)), "fold_ordered is not bit-exact on the embedding leaf")
    print(f"K4 fold_ordered K=2 n={EMBED_N} (host numpy in and out) {card}: wall {wall * 1e3:.2f} ms: H2D {times['h2d_ms']:.2f} ms, launch + kernel {times['kernel_ms']:.4f} ms, D2H {times['d2h_ms']:.2f} ms (CUDA events)", flush=True)
    return entry


def round_phase(seed: int, card: str) -> int:
    """Phase 8: one full-width FedAvg round on loopback, folded by K4 on
    the card. Returns K4's launches during it."""
    with tempfile.TemporaryDirectory() as out_dir:
        server = build_round_server(build_parser().parse_args(
            ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2",
             "--timeout", "600", "--device", "cuda"]
        ))
        check(server.device.type == "cuda", f"server folds on {server.device}")
        results: dict[int, dict] = {}
        errors: list[BaseException] = []

        def client(i: int) -> None:
            try:
                results[i] = run_client(build_parser().parse_args(
                    ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
                     "--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400",
                     "--epochs", "1", "--rounds", "1", "--seed", str(seed), "--timeout", "600",
                     "--output-dir", out_dir]
                ))
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        fold_mod.FOLD_LAUNCHES = 0
        flash_mod.FWD_LAUNCHES = flash_mod.FWD_DROPOUT_LAUNCHES = 0
        flash_mod.DKDV_LAUNCHES = flash_mod.DQ_LAUNCHES = flash_mod.BWD_DO_COPIES = 0
        t0 = time.perf_counter()
        with server:
            st = threading.Thread(target=server.serve, args=(1,))
            workers = [threading.Thread(target=client, args=(i,)) for i in range(2)]
            for t in (st, *workers):
                t.start()
            for t in (*workers, st):
                t.join(timeout=900)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = fold_mod.FOLD_LAUNCHES
        flash = (flash_mod.FWD_LAUNCHES, flash_mod.FWD_DROPOUT_LAUNCHES, flash_mod.DKDV_LAUNCHES, flash_mod.DQ_LAUNCHES)
        check(not any(t.is_alive() for t in (st, *workers)), "round threads hung")
        if errors:
            raise errors[0]
        csvs = {}
        for i in range(2):
            for path in results[i]["metrics_csvs"]:
                with open(path) as f:
                    csvs[os.path.basename(path)] = f.read().strip().splitlines()
    check(sorted(csvs) == [f"client{i}_{p}_metrics.csv" for i in range(2) for p in ("aggregated", "local")],
          f"metrics CSVs {sorted(csvs)}")
    for name, (header, values) in csvs.items():
        check(header == "Accuracy,Loss,Precision,Recall,F1-Score", f"{name} header {header!r}")
        check(all(np.isfinite(float(v)) for v in values.split(",")), f"{name} {values!r}")
    uploads = [wire.flatten_params(results[i]["uploaded"]) for i in range(2)]
    aggs = [wire.flatten_params(results[i]["aggregate"]) for i in range(2)]
    n_leaves = len(uploads[0])
    n_params = sum(a.size for a in uploads[0].values())
    print(f"round: {n_leaves} leaves, {n_params} fp32 parameters ({n_params * 4 / 1e6:.2f} MB) per upload; K4 launches {launches}; flash launches (K1 rate 0, K1 dropout, K2, K3) {flash}", flush=True)
    check(n_leaves == 102 and launches == n_leaves, f"K4 launched {launches} times for {n_leaves} leaves (want one per leaf, 102)")
    check(aggs[0].keys() == aggs[1].keys() and all(np.array_equal(aggs[0][k], aggs[1][k]) for k in aggs[0]),
          "the two clients received different aggregates")
    w = np.ones(2, np.float64) / 2  # unweighted FedAvg: StreamAgg's weight math
    ref = {
        key: fold_mod.fold_reference([torch.from_numpy(u[key]) for u in uploads], [np.float32(x) for x in w]).numpy()
        for key in uploads[0]
    }
    crc, want = wire.flat_crc32(aggs[0]), wire.flat_crc32(ref)
    print(f"round: aggregate crc {crc:#010x}, fold_reference over the uploads {want:#010x}", flush=True)
    check(crc == want, "the round's aggregate differs from the plain fold of the uploads")
    steps = [results[i]["state"].step for i in range(2)]
    mcfg = results[0]["config"].model
    check(flash[1] == flash[2] == flash[3] == mcfg.n_layers * sum(steps),
          f"K1-dropout/K2/K3 launches {flash[1:]} for {steps} steps")
    check(flash_mod.BWD_DO_COPIES == 0, f"the clients' backward copied dO {flash_mod.BWD_DO_COPIES} times")
    eval_batches = sum(2 * -(-results[i]["local"]["n"] // results[i]["config"].data.eval_batch_size) for i in range(2))
    check(flash[0] == mcfg.n_layers * eval_batches, f"K1 (rate 0) launches {flash[0]} for {eval_batches} eval batches")
    stats = server.last_fold_stats
    check(stats["fold_engine"] == "cuda", f"fold engine {stats['fold_engine']}")
    for i in range(2):
        s, x = results[i]["seconds"], results[i]["exchange"]
        print(
            f"round: client {i}: set-up {s['setup']:.3f} s, train {s['train']:.3f} s ({steps[i]} steps), eval {s['eval_local']:.3f} s, "
            f"host_params {s['host_params']:.3f} s, upload {x['upload_s']:.3f} s ({x['upload_bytes'] / 1e6:.1f} MB), "
            f"wait for the reply {x['reply_wait_s']:.3f} s ({x['reply_bytes'] / 1e6:.1f} MB), "
            f"re-evaluation {s['eval_aggregated']:.3f} s, adopt {s['adopt']:.3f} s",
            flush=True,
        )
    ph = server.phase_seconds
    print(
        f"round: server {card}: wait {ph['wait']:.3f} s, agg {ph['agg']:.3f} s (fold {stats['fold_s']:.3f} s = "
        f"H2D {stats['fold_h2d_ms']:.2f} ms, launch + kernel {stats['fold_kernel_ms']:.3f} ms, D2H {stats['fold_d2h_ms']:.2f} ms "
        f"by CUDA events, over {launches} leaves), reply {ph['reply']:.3f} s; round wall {wall:.3f} s",
        flush=True,
    )
    return launches


def rounds_invocation(seed: int, card: str, name: str, serve_flags: list[str], client_flags: list[list[str]],
                      secret: str | None = None) -> tuple[list[dict], dict[int, dict]]:
    """One ``serve`` + two ``client``s over ROUNDS rounds on loopback, all
    through the port's parser, the fold on the card. Returns the server's
    per-round record (the previous global, the folded mean, the new global,
    what arrived, fold stats, K4 launches, the round's seconds) and each
    client's ``run_client`` result."""
    old_secret = os.environ.pop("FEDTPU_SECRET", None)
    if secret is not None:
        os.environ["FEDTPU_SECRET"] = secret
    records: list[dict] = []
    results: dict[int, dict] = {}
    errors: list[BaseException] = []
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            server = build_round_server(build_parser().parse_args(
                ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--timeout", "600",
                 "--device", "cuda", *serve_flags]
            ))
            check(server.device.type == "cuda", f"server folds on {server.device}")

            def serve() -> None:
                try:
                    for _ in range(ROUNDS):
                        prev, k4, t0 = server._last_agg, fold_mod.FOLD_LAUNCHES, time.perf_counter()
                        ph0 = dict(server.phase_seconds)
                        agg = server.serve_round()
                        records.append({
                            "prev": prev, "mean": server.last_mean, "global": agg,
                            "uploads": dict(server.last_uploads), "fold": dict(server.last_fold_stats),
                            "k4": fold_mod.FOLD_LAUNCHES - k4, "wall": time.perf_counter() - t0,
                            "phases": {k: server.phase_seconds[k] - ph0[k] for k in ph0},
                        })
                except BaseException as e:  # re-raised below, after the join
                    errors.append(e)

            def client(i: int) -> None:
                try:
                    results[i] = run_client(build_parser().parse_args(
                        ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
                         *ROUND_CLIENT_ARGS, "--seed", str(seed), "--output-dir", out_dir, *client_flags[i]]
                    ))
                except BaseException as e:  # re-raised below, after the join
                    errors.append(e)

            with server:
                threads = [threading.Thread(target=serve)] + [threading.Thread(target=client, args=(i,)) for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
            check(not any(t.is_alive() for t in threads), f"rounds ({name}) threads hung")
    finally:
        os.environ.pop("FEDTPU_SECRET", None)
        if old_secret is not None:
            os.environ["FEDTPU_SECRET"] = old_secret
    if errors:
        raise errors[0]
    check(len(records) == ROUNDS and all(len(results[i]["rounds"]) == ROUNDS for i in range(2)),
          f"rounds ({name}): {len(records)} server rounds, clients {[len(results[i]['rounds']) for i in range(2)]}")
    for r, rec in enumerate(records):
        fold = rec["fold"]
        check(fold["fold_engine"] == "cuda", f"rounds ({name}) round {r + 1} folded on {fold['fold_engine']}")
        check(rec["k4"] == 102, f"rounds ({name}) round {r + 1}: K4 launched {rec['k4']} times (want one per leaf, 102)")
        for i in range(2):
            x = results[i]["rounds"][r]["exchange"]
            sec = results[i]["rounds"][r]["seconds"]
            up = rec["uploads"][i]
            print(
                f"rounds ({name}) round {r + 1} {card}: client {i}: upload {x['upload_shape']} {x['wire_dtype']} "
                f"{x['upload_bytes'] / 1e6:.2f} MB in {x['upload_s']:.3f} s (server saw {up['shape']} {up['wire_dtype']} "
                f"{up['bytes'] / 1e6:.2f} MB), reply {x['reply_shape']} {x['reply_bytes'] / 1e6:.2f} MB "
                f"{x['reply_wait_s']:.3f} s after the upload; train {sec['train']:.3f} s, eval {sec['eval_local']:.3f} s, "
                f"exchange {sec['exchange']:.3f} s (next round's prefetch {sec.get('prefetch', 0.0):.3f} s under it), "
                f"re-evaluation {sec['eval_aggregated']:.3f} s, adopt {sec['adopt']:.3f} s",
                flush=True,
            )
        ph = rec["phases"]
        print(
            f"rounds ({name}) round {r + 1} {card}: fold early {fold['early_bytes'] / 1e6:.1f} MB in "
            f"{fold['early_s']:.3f} s, late {fold['late_bytes'] / 1e6:.1f} MB in {fold['late_s']:.3f} s "
            f"(overlap {fold['overlap_frac']:.3f}); K4 {rec['k4']} launches, launch + kernel "
            f"{fold['fold_kernel_ms']:.3f} ms, H2D {fold['fold_h2d_ms']:.2f} ms, D2H {fold['fold_d2h_ms']:.2f} ms "
            f"(CUDA events); server wait {ph['wait']:.3f} s, agg {ph['agg']:.3f} s, reply {ph['reply']:.3f} s; "
            f"round wall {rec['wall']:.3f} s",
            flush=True,
        )
    return records, results


def plain_mean(decoded: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """fold_reference over the uploads as the server decoded them
    (unweighted, ascending client id), on the host."""
    w = [np.float32(x) for x in np.ones(len(decoded), np.float64) / len(decoded)]
    return {
        key: fold_mod.fold_reference([torch.from_numpy(np.ascontiguousarray(d[key])) for d in decoded], w).numpy()
        for key in decoded[0]
    }


def check_int8c_step(got: np.ndarray, x: np.ndarray, what: str) -> float:
    """int8c: each value within half its chunk's scale (max|chunk| / 127);
    returns the largest error as a fraction of that half-step."""
    flat = np.ascontiguousarray(x, np.float32).reshape(-1)
    n = flat.size
    pad = -n % QUANT_CHUNK_ELEMS
    chunks = np.pad(np.abs(flat), (0, pad)).reshape(-1, QUANT_CHUNK_ELEMS)
    half = np.repeat(chunks.max(axis=1) / np.float32(127.0) / 2, QUANT_CHUNK_ELEMS)[:n]
    err = np.abs(np.asarray(got, np.float32).reshape(-1) - flat)
    ratio = float((err / np.maximum(half, np.float32(1e-30))).max())
    # A value on a half-step tie lands half a step away; the division by
    # the fp32 scale and the dequantizing product add an ulp or two.
    slack = 2 * np.spacing(np.abs(flat)) + half * np.float32(1e-5)
    check(bool((err <= half + slack).all()), f"{what}: int8c error beyond half a step ({ratio:.6f})")
    return ratio


def rounds_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 9: several rounds of the streamed round at full width, in two
    invocations: (a) the JAX package's default shape made authenticated
    (FEDTPU_SECRET, 4 MB stream chunks, FedProx on the server and both
    clients); (b) the lossy wires (int8c streams, a bf16 streamed reply,
    top-k sparse deltas, FedAdam on the server). Returns the phase's
    launches of each kernel."""
    counts_zero()
    fold_mod.FOLD_LAUNCHES = 0
    t0 = time.perf_counter()
    # (a) ------------------------------------------------------------------
    recs, res = rounds_invocation(
        seed, card, "a", ["--strategy", "fedprox:mu=0.01"], [["--prox-mu", "0.01"]] * 2,
        secret=f"smoke-{seed}-shared-secret",
    )
    for r, rec in enumerate(recs):
        shapes = [rec["uploads"][i]["shape"] for i in range(2)]
        check(shapes == (["dense"] * 2 if r == 0 else ["stream"] * 2), f"rounds (a) round {r + 1} arrived as {shapes}")
        uploads = [wire.flatten_params(res[i]["rounds"][r]["uploaded"]) for i in range(2)]
        crc, want = wire.flat_crc32(rec["mean"]), wire.flat_crc32(plain_mean(uploads))
        print(f"rounds (a) round {r + 1}: aggregate crc {crc:#010x}, fold_reference over the uploads {want:#010x}", flush=True)
        check(crc == want, f"rounds (a) round {r + 1}: the aggregate differs from the plain fold of the uploads")
        check(wire.flat_crc32(rec["global"]) == crc, "fedprox changed the server's global")
        for i in range(2):
            meta = res[i]["rounds"][r]["exchange"]["meta"]
            check(meta["strategy"] == {"name": "fedprox", "params": {"mu": 0.01}} and "nonce" in meta,
                  f"rounds (a) client {i} round {r + 1} reply meta {sorted(meta)}")
            got = wire.flatten_params(res[i]["rounds"][r]["aggregate"])
            check(wire.flat_crc32(got) == crc, f"rounds (a) client {i} received another aggregate in round {r + 1}")
    check(all(res[i]["config"].train.prox_mu == 0.01 for i in range(2)), "the clients do not train with FedProx")
    native_wire_check(card, res[0]["rounds"][0]["uploaded"])
    a_steps = sum(res[i]["state"].step for i in range(2))
    a_evals = sum(2 * -(-res[i]["local"]["n"] // res[i]["config"].data.eval_batch_size) for i in range(2)) * ROUNDS
    # (b) ------------------------------------------------------------------
    recs_b, res_b = rounds_invocation(
        seed + 1, card, "b", ["--reply-dtype", "bf16", "--strategy", "fedopt:opt=adam,lr=0.1"],
        [["--wire-dtype", "int8"], ["--compression", "topk:0.01", "--no-stream-upload"]],
    )
    opt = ServerOptimizer("adam", 0.1)
    opt_state = None
    residual = None
    int8c_worst = bf16_worst = 0.0
    for r, rec in enumerate(recs_b):
        arrived = [(rec["uploads"][i]["shape"], rec["uploads"][i]["wire_dtype"]) for i in range(2)]
        want_arrived = [("dense", "fp32") if r == 0 else ("stream", "int8"), ("dense", "fp32")]
        check(arrived == want_arrived, f"rounds (b) round {r + 1} arrived as {arrived}")
        x0 = wire.flatten_params(res_b[0]["rounds"][r]["uploaded"])
        x1 = wire.flatten_params(res_b[1]["rounds"][r]["uploaded"])
        if r == 0:
            d0, d1 = x0, x1
        else:
            d0 = {k: dequantize_int8c(quantize_int8c(v), v.shape) for k, v in x0.items()}
            for k in x0:
                int8c_worst = max(int8c_worst, check_int8c_step(d0[k], x0[k], f"rounds (b) round {r + 1} {k}"))
            # Client 1's sparse delta, replayed: its base is the previous
            # global (its exact fp32 reply), its error feedback the residual.
            base = recs_b[r - 1]["global"]
            delta = {k: x1[k] - base[k] + (residual[k] if residual else np.float32(0)) for k in base}
            dense = {}
            for k, v in delta.items():
                payload = wire.sparsify_topk(v, 0.01)
                kept = int(np.frombuffer(payload[:4], np.uint32)[0])
                check(kept == max(1, round(0.01 * v.size)), f"top-k kept {kept} of {v.size} entries of {k}")
                dense[k] = wire.densify_topk(payload, v.shape)
            residual = {k: delta[k] - dense[k] for k in delta}
            d1 = {k: base[k] + dense[k] for k in base}
        crc, want = wire.flat_crc32(rec["mean"]), wire.flat_crc32(plain_mean([d0, d1]))
        print(f"rounds (b) round {r + 1}: mean crc {crc:#010x}, fold_reference over the decoded uploads {want:#010x}", flush=True)
        check(crc == want, f"rounds (b) round {r + 1}: the mean differs from the plain fold of the decoded uploads")
        # The post-strategy global: ServerOptimizer on the card, same mean.
        if rec["prev"] is None:
            ref = rec["mean"]
        else:
            keys = sorted(rec["mean"])
            prev = {k: torch.tensor(rec["prev"][k], device="cuda") for k in keys}
            grad = {k: prev[k] - torch.tensor(rec["mean"][k], device="cuda") for k in keys}
            opt_state = opt.init(prev) if opt_state is None else opt_state
            updates, opt_state = opt.update(grad, opt_state)
            ref = {k: (prev[k] + updates[k]).cpu().numpy() for k in keys}
        check(all(np.array_equal(rec["global"][k], ref[k]) for k in ref),
              f"rounds (b) round {r + 1}: the server's FedAdam global differs from ServerOptimizer on the card")
        g = rec["global"]
        got0 = wire.flatten_params(res_b[0]["rounds"][r]["aggregate"])
        got1 = wire.flatten_params(res_b[1]["rounds"][r]["aggregate"])
        check(wire.flat_crc32(got1) == wire.flat_crc32(g), f"rounds (b) round {r + 1}: client 1's dense reply is not exact")
        for k in g:
            err = np.abs(got0[k] - g[k])
            bound = np.abs(g[k]) * np.float32(2.0**-8)
            check(bool((err <= bound).all()), f"rounds (b) round {r + 1} {k}: bf16 reply beyond 2^-8 relative")
            nz = g[k] != 0
            if nz.any():
                bf16_worst = max(bf16_worst, float((err[nz] / np.abs(g[k][nz])).max()))
        ups = [res_b[i]["rounds"][r]["exchange"]["upload_bytes"] for i in range(2)]
        print(f"rounds (b) round {r + 1}: upload bytes {ups[0] / 1e6:.3f} MB ({'int8c' if r else 'fp32'}) and "
              f"{ups[1] / 1e6:.3f} MB ({'top-k 0.01' if r else 'fp32'})", flush=True)
    check(res_b[1]["rounds"][-1]["exchange"]["upload_bytes"] < 0.1 * res_b[1]["rounds"][0]["exchange"]["upload_bytes"],
          "client 1's sparse uploads are not sparse")
    print(f"rounds (b): worst int8c error {int8c_worst:.4f} of half a chunk step; worst bf16 reply error "
          f"{bf16_worst:.3e} relative (bound 2^-8 = {2.0**-8:.3e})", flush=True)
    b_steps = sum(res_b[i]["state"].step for i in range(2))
    b_evals = sum(2 * -(-res_b[i]["local"]["n"] // res_b[i]["config"].data.eval_batch_size) for i in range(2)) * ROUNDS
    launches = counts_read()
    launches["fold"] = fold_mod.FOLD_LAUNCHES
    n_layers = res[0]["config"].model.n_layers
    steps = a_steps + b_steps
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == n_layers * steps,
          f"rounds: K1-dropout/K2/K3 launches {launches} for {steps} steps")
    check(launches["flash_fwd"] == n_layers * (a_evals + b_evals), f"rounds: K1 (rate 0) launches {launches['flash_fwd']} for {a_evals + b_evals} eval batches")
    check(flash_mod.BWD_DO_COPIES == 0, f"the clients' backward copied dO {flash_mod.BWD_DO_COPIES} times")
    check(launches["fold"] == 2 * ROUNDS * 102, f"rounds: K4 launched {launches['fold']} times")
    print(f"rounds: launches {launches}; {steps} client steps; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# The serving phase's load: 256 distinct flows, half sent as text and half
# as features; the closed loop 16 connections x 8 in flight.
SERVE_FLOWS = 256
SERVE_SECRET = "chip-smoke-scoring-secret"
ARRIVAL_TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "arrival_bursty.trace")


def served_buckets(stats: dict, before: dict) -> list[int]:
    """The engine buckets the batches since ``before`` landed in."""
    sizes = [int(n) for n, c in stats["batch_size_hist"].items() if c > before["batch_size_hist"].get(n, 0)]
    return sorted({next(b for b in BUCKETS if b >= n) for n in sizes})


def load_line(card: str, mode: str, res: dict) -> None:
    sizes = np.asarray(res["batch_sizes"])
    print(
        f"serving: {card}: {mode}: {res['scored']} replies in {res['wall_s']:.3f} s = {res['flows_per_sec']:.1f} flows/s; "
        f"client latency p50 {res['p50_ms']:.2f} p95 {res['p95_ms']:.2f} p99 {res['p99_ms']:.2f} ms; "
        f"batch size per reply mean {res['mean_batch']:.1f} max {res['max_batch']} "
        f"(p50 {np.percentile(sizes, 50):.0f}); rejected {res['rejected']}",
        flush=True,
    )


def dot_probs(cfg: ModelConfig, params: dict, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """P(attack) and class probs of ``texts`` through attention_impl="dot" on the card."""
    tok = default_tokenizer()
    enc = tok.batch_encode(texts, max_len=cfg.max_len)
    dot = ScoreEngine(dataclasses.replace(cfg, attention_impl="dot"), params, pad_id=tok.pad_id)
    out = [dot.score(enc["input_ids"][i : i + 128], enc["attention_mask"][i : i + 128]) for i in range(0, len(texts), 128)]
    return np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out])


def serve_args(*argv: str) -> list[str]:
    return ["infer-serve", *argv, "--host", "127.0.0.1", "--port", "0", "--max-wait-ms", "5"]


def auth_and_load(seed: int, card: str, reg: str, cfg: ModelConfig, params: dict) -> tuple[int, int, list[str]]:
    """Serving (a) and (b). Returns K1's rate-0 launches, the batches they
    served and every text the server rendered."""
    key = SERVE_SECRET.encode()
    records = flow_records(seed + 30, SERVE_FLOWS)
    texts = [flow_to_text(r) for r in records]
    flows = [texts[i] if i % 2 else records[i] for i in range(SERVE_FLOWS)]
    server = build_server(build_parser().parse_args(serve_args("--registry-dir", reg, "--auth", "--reload-poll", "3600")))
    check(server.engine.device.type == "cuda" and server.auth_key == key, f"engine on {server.engine.device}, auth {server.auth_key}")
    replies = 0
    with server:
        counts_zero()
        base = fetch_stats("127.0.0.1", server.port, auth_key=key)
        replies_base = base["scored"]
        for bad in (None, b"wrong-key"):
            try:
                with ScoringClient("127.0.0.1", server.port, auth_key=bad, timeout=10) as c:
                    c.score(text=texts[0])
                fail(f"a client with key {bad!r} was answered")
            except (WireError, OSError):
                pass
        t_wait = time.perf_counter()
        while fetch_stats("127.0.0.1", server.port, auth_key=key)["rejects"]["auth"] < 2 and time.perf_counter() - t_wait < 10:
            time.sleep(0.05)
        rejects = fetch_stats("127.0.0.1", server.port, auth_key=key)["rejects"]
        print(f"serving: no key and a wrong key both dropped: rejects {rejects}", flush=True)
        check(rejects["auth"] == 2 and sum(rejects.values()) == 2, f"auth rejects {rejects}, want 2")
        with ScoringClient("127.0.0.1", server.port, auth_key=key) as c:  # a lone request: bucket 1
            sampled = [c.score(**({"text": f} if isinstance(f, str) else {"features": f})) for f in flows[:64]]
        replies += len(sampled)
        closed = run_load("127.0.0.1", server.port, flows, concurrency=16, pipeline=8, requests=2048, auth_key=key, timeout=120)
        load_line(card, "closed loop (16 connections x 8 in flight, 2048 requests)", closed)
        qps = closed["flows_per_sec"] / 2
        open_ = run_load("127.0.0.1", server.port, flows, concurrency=4, target_qps=qps, requests=1024, auth_key=key, timeout=120)
        load_line(card, f"open loop at {qps:.1f} flows/s (half the closed loop's; 1024 requests)", open_)
        trace = run_load("127.0.0.1", server.port, flows, concurrency=4, requests=512, auth_key=key, timeout=120,
                         arrival_trace=load_arrival_trace(ARRIVAL_TRACE))
        load_line(card, f"arrival trace tests/data/arrival_bursty.trace ({trace['arrival_trace_len']} gaps, "
                        f"{trace['arrival_cycle_s']:.3f} s a cycle; 512 requests)", trace)

        async def async_scores():
            c = await AsyncScoringClient.connect("127.0.0.1", server.port, auth_key=key)
            try:
                t0 = time.perf_counter()
                out = await asyncio.gather(*(c.score(text=t) for t in texts[:64]))
                return out, time.perf_counter() - t0
            finally:
                await c.close()

        async_replies, async_s = asyncio.run(async_scores())
        print(f"serving: {card}: asyncio client: 64 concurrent scores on one connection in {async_s * 1e3:.1f} ms, "
              f"batch sizes {sorted({r['batch_size'] for r in async_replies})}", flush=True)
        for res in (closed, open_, trace):
            check(res["scored"] == len(res["batch_sizes"]) and res["rejected"] == 0, f"run_load {res['scored']} scored, {res['rejected']} rejected")
            replies += res["scored"]
        replies += len(async_replies)
        check(closed["scored"] == 2048 and open_["scored"] == 1024 and trace["scored"] == 512, "run_load lost replies")
        stats = fetch_stats("127.0.0.1", server.port, auth_key=key)
        torch.cuda.synchronize()
        launches = flash_mod.FWD_LAUNCHES
        check(flash_mod.FWD_DROPOUT_LAUNCHES == 0, "serving launched K1 with dropout")
        scored = stats["scored"] - replies_base
        batches = stats["batches"] - base["batches"]
        buckets = served_buckets(stats, base)
        print(f"serving: {scored} flows in {batches} batches (mean {scored / batches:.1f}), buckets hit {buckets}, "
              f"K1 launches {launches}; server p50 {stats['p50_ms']:.2f} p95 {stats['p95_ms']:.2f} p99 {stats['p99_ms']:.2f} ms", flush=True)
        check(scored == replies, f"the server scored {scored} flows, the clients counted {replies} replies")
        check(sum(stats["score_hist"]) == stats["scored"], f"score_hist sums to {sum(stats['score_hist'])}, scored {stats['scored']}")
        check(buckets == list(BUCKETS), f"buckets hit {buckets}, want {list(BUCKETS)}")
        check(launches == cfg.n_layers * batches, f"K1 launched {launches} times for {batches} batches")
        # flows[i] is texts[i] or the record it renders to.
        want, _ = dot_probs(cfg, params, texts[:64])
        diff = float(np.abs(np.array([r["prob"] for r in sampled]) - want).max())
        diff_async = float(np.abs(np.array([r["prob"] for r in async_replies]) - want).max())
        print(f"serving: 64 sampled replies (32 text, 32 features) and the 64 asyncio replies vs the dot path on the "
              f"card: max|diff| {diff:.3e} and {diff_async:.3e} (bf16 atol 1e-2)", flush=True)
        check(diff <= 1e-2 and diff_async <= 1e-2, f"served probs differ from the dot path by {diff} / {diff_async}")
        check(server.tok.native_active, f"the server tokenized without the native encoder: {native.build_error('wordpiece.cpp')}")

        # (b) Promote a second artifact and send one reload frame.
        new_params = {n: t.clone() for n, t in params.items()}
        new_params["classifier.bias"] = new_params["classifier.bias"] + torch.tensor([2.0, -2.0])
        counts_zero()
        batches0 = fetch_stats("127.0.0.1", server.port, auth_key=key)["batches"]
        publish(reg, new_params, 2, cfg)
        with ScoringClient("127.0.0.1", server.port, auth_key=key) as c:
            t0 = time.perf_counter()
            reload = c.reload()
            reload_s = time.perf_counter() - t0
            after = [c.score(text=t) for t in texts[:64]]
        want_new, _ = dot_probs(cfg, new_params, texts[:64])
        want_old, _ = dot_probs(cfg, params, texts[:64])
        stats = fetch_stats("127.0.0.1", server.port, auth_key=key)
        torch.cuda.synchronize()
        launches += flash_mod.FWD_LAUNCHES
        batches += stats["batches"] - batches0
        probs = np.array([r["prob"] for r in after])
        diff, gap = float(np.abs(probs - want_new).max()), float(np.abs(want_new - want_old).max())
        print(f"serving: {card}: reload frame answered in {reload_s:.3f} s: {reload}; {len(after)} replies after it name rounds "
              f"{sorted({r['round'] for r in after})}, max|prob - dot on the new weights| {diff:.3e} (bf16 atol 1e-2); "
              f"new vs old weights differ by up to {gap:.3e} (must exceed 10 x 1e-2)", flush=True)
        check(reload["reloaded"] is True and reload["round"] == 2, f"reload reply {reload}")
        check({r["round"] for r in after} == {2}, "replies after the reload frame name another round")
        check(diff <= 1e-2 and gap > 10 * 1e-2, f"reloaded probs off by {diff} (weights gap {gap})")
        check(stats["reload_frames"] == 1 and stats["reloads"] == 1, f"reload_frames {stats['reload_frames']}, reloads {stats['reloads']}")
        check(launches == cfg.n_layers * batches, f"K1 launched {launches} times for {batches} batches")
    return launches, batches, [flow_to_text(r) for r in records]


def schemas(seed: int, card: str, work: str) -> tuple[dict[str, int], list[str]]:
    """Serving (c): ``local`` on UNSW-NB15 at full width, that checkpoint
    served with ``--dataset unswnb15``, and a K=7 artifact served with
    ``--dataset cicddos2019-mc``. Returns the kernels' launches and the
    texts the servers rendered."""
    ckpt = os.path.join(work, "unsw_ckpt")
    counts_zero()
    res = run_local(build_parser().parse_args(
        ["local", "--dataset", "unswnb15", "--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400",
         "--epochs", "1", "--seed", str(seed), "--output-dir", os.path.join(work, "unsw_out"), "--checkpoint-dir", ckpt]
    ))
    launches = counts_read()
    cfg = res["config"]
    n_layers, steps = cfg.model.n_layers, res["state"].step
    eval_batches = sum(-(-res[s]["n"] // cfg.data.eval_batch_size) for s in ("val", "test"))
    with open(res["metrics_csv"]) as f:
        header, values = f.read().strip().splitlines()
    print(f"serving: {card}: local --dataset unswnb15: {steps} steps, losses {res['losses']}, launches {launches}; test {header} = {values}", flush=True)
    check(cfg.data.dataset == "unswnb15" and cfg.model.dim == 768 and steps == 9, f"local ran {cfg.data.dataset} at {cfg.model.dim} for {steps} steps")
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == n_layers * steps,
          f"K1-dropout/K2/K3 launches {launches} for {steps} steps")
    check(launches["flash_fwd"] == n_layers * eval_batches, f"K1 (rate 0) launches {launches['flash_fwd']} for {eval_batches} eval batches")
    check(all(np.isfinite(float(v)) for v in values.split(",")) and all(np.isfinite(res["losses"])), f"metrics {values}, losses {res['losses']}")
    served: list[str] = []

    unsw = make_synthetic("unswnb15", 64, seed=seed + 31)
    spec = get_dataset("unswnb15")
    records = [{c: unsw[c][i].item() for c in spec.feature_columns} for i in range(64)]
    texts = spec.render_texts(unsw)
    server = build_server(build_parser().parse_args(serve_args("--checkpoint-dir", ckpt, "--dataset", "unswnb15")))
    with server:
        counts_zero()
        batches0 = server.stats()["batches"]
        with ScoringClient("127.0.0.1", server.port) as c:
            replies = [c.score(features=r) for r in records]
        k1 = counts_read()["flash_fwd"]
        batches = server.stats()["batches"] - batches0
    with Checkpointer(ckpt) as ck:
        trained = ck.restore_params(step=steps)
    want, _ = dot_probs(server.engine.model_cfg, trained, texts)
    diff = float(np.abs(np.array([r["prob"] for r in replies]) - want).max())
    print(f"serving: infer-serve --checkpoint-dir --dataset unswnb15: 64 UNSW features replies vs the dot path on the same "
          f"rendered texts: max|diff| {diff:.3e} (bf16 atol 1e-2)", flush=True)
    check(diff <= 1e-2, f"UNSW replies differ from the dot path by {diff}")
    check(k1 == n_layers * batches, f"K1 launched {k1} times for {batches} batches")
    launches["flash_fwd"] += k1
    served += texts

    tok = default_tokenizer()
    cfg7 = ModelConfig.distilbert_base(vocab_size=len(tok.vocab), attention_impl="flash", compute_dtype="bfloat16", n_classes=7)
    params7 = init_params(cfg7, torch.Generator().manual_seed(seed + 32))
    reg7 = os.path.join(work, "registry_mc")
    publish(reg7, params7, 1, cfg7)
    ddos = make_synthetic("cicddos2019", 64, seed=seed + 33)
    mc = get_dataset("cicddos2019-mc")
    records = [{c: ddos[c][i].item() for c in mc.feature_columns} for i in range(64)]
    texts = mc.render_texts(ddos)
    server = build_server(build_parser().parse_args(serve_args("--registry-dir", reg7, "--dataset", "cicddos2019-mc")))
    with server:
        counts_zero()
        batches0 = server.stats()["batches"]
        res = run_load("127.0.0.1", server.port, records, concurrency=8, timeout=120)
        with ScoringClient("127.0.0.1", server.port) as c:
            replies = [c.score(features=r) for r in records]
        k1 = counts_read()["flash_fwd"]
        batches = server.stats()["batches"] - batches0
    cp = np.array([r["class_probs"] for r in replies], np.float64)
    prob = np.array([r["prob"] for r in replies], np.float64)
    want_p, want_cp = dot_probs(cfg7, params7, texts)
    sums = float(np.abs(cp.sum(1) - 1).max())
    head = float(np.abs(prob - (1 - cp[:, 0])).max())
    diff = float(np.abs(cp - want_cp).max())
    print(f"serving: {card}: K=7 artifact (cicddos2019-mc): {res['scored'] + len(replies)} replies, class_probs {cp.shape}, "
          f"max|sum - 1| {sums:.2e} (1e-5), max|prob - (1 - class_probs[0])| {head:.2e} (1e-6), max|class_probs - dot| "
          f"{diff:.3e} (bf16 atol 1e-2)", flush=True)
    check(res["scored"] == 64 and cp.shape == (64, 7) and sums <= 1e-5 and head <= 1e-6, f"K=7 replies: shape {cp.shape}, sums {sums}, head {head}")
    check(diff <= 1e-2 and float(np.abs(prob - want_p).max()) <= 1e-2, f"K=7 class_probs differ from the dot path by {diff}")
    check(k1 == cfg7.n_layers * batches, f"K1 launched {k1} times for {batches} batches")
    launches["flash_fwd"] += k1
    served += texts
    return launches, served


def tokenizer_check(card: str, texts: list[str]) -> None:
    """Serving (d): the native encoder is active here, its ids on every
    served text equal the Python encoder's; µs per flow for both."""
    tok = default_tokenizer()
    err = native.build_error("wordpiece.cpp")
    got = tok.batch_encode(texts, max_len=128)
    check(tok.native_active, f"the native WordPiece encoder is not active on this machine: {err}")
    t0 = time.perf_counter()
    for _ in range(5):
        got = tok.batch_encode(texts, max_len=128)
    t_native = (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    want = tok.batch_encode_python(texts, max_len=128)
    t_python = time.perf_counter() - t0
    same = all(np.array_equal(got[k], want[k]) for k in ("input_ids", "attention_mask"))
    print(f"serving: {card}: tokenizer over {len(texts)} served texts: native {t_native / len(texts) * 1e6:.2f} us/flow, "
          f"Python {t_python / len(texts) * 1e6:.2f} us/flow; ids array-equal: {same} (library {native.library_path('wordpiece.cpp')})", flush=True)
    check(same, "the native encoder's ids differ from the Python encoder's")


def serving_phase(seed: int, card: str) -> dict[str, int]:
    """Auth, load, reload frame, schemas and tokenizer at full width on
    the card. Returns each flash kernel's launches during it."""
    t0 = time.perf_counter()
    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(vocab_size=len(tok.vocab), attention_impl="flash", compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(seed + 29))
    old_secret = os.environ.get("FEDTPU_SECRET")
    os.environ["FEDTPU_SECRET"] = SERVE_SECRET
    try:
        with tempfile.TemporaryDirectory() as work:
            reg = os.path.join(work, "registry")
            publish(reg, params, 1, cfg)
            k1_serve, _, served = auth_and_load(seed, card, reg, cfg, params)
            del os.environ["FEDTPU_SECRET"]
            launches, more = schemas(seed, card, work)
            k1_serve += max_len_serve(card, work, cfg, params, served)["flash_fwd"]
    finally:
        if old_secret is None:
            os.environ.pop("FEDTPU_SECRET", None)
        else:
            os.environ["FEDTPU_SECRET"] = old_secret
    tokenizer_check(card, served + more)
    launches["flash_fwd"] += k1_serve
    print(f"serving: launches {launches}; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------- slice 12
#: K1, K2 and K3 as their mangled names show in a torch.profiler trace.
KERNEL_FRAGMENTS = {"K1": "flash_fwd", "K2": "flash_dkdv", "K3": "flash_dq"}
STEP_FAMILIES = ("fedtpu_train_step_seconds", "fedtpu_score_step_seconds", "fedtpu_wire_step_seconds")
OBS_FLOWS = 64


def registry_value(name: str, labels: dict | None = None) -> float:
    """A family's value (a histogram's count) on the process registry,
    summed over the samples whose labels match ``labels``."""
    fam = obs_mod.default_registry().snapshot()["families"].get(name)
    if fam is None:
        return 0.0
    return sum(
        s.get("count", s.get("value", 0.0)) for s in fam["samples"] if labels is None or s["labels"] == labels
    )


def trace_kernel_counts(log_dir: str) -> tuple[dict[str, int], int, float]:
    """K1/K2/K3 kernel events (by substring of their mangled names) in
    the one Chrome trace under ``log_dir``, all its CUDA kernel events,
    and the share of the span from the first kernel's start to the last
    one's end that some kernel ran (the device's busy share); a trace
    without CUDA kernel events fails."""
    names = [n for n in os.listdir(log_dir) if n.endswith(".json")]
    check(len(names) == 1, f"{log_dir} holds traces {names}, want one")
    with open(os.path.join(log_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    check(kernels, f"the torch.profiler trace {names[0]} holds no CUDA kernel events")
    busy, end = 0.0, None
    for e in sorted(kernels, key=lambda e: float(e["ts"])):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if end is None or t0 >= end:
            busy += t1 - t0
        elif t1 > end:
            busy += t1 - end
        end = t1 if end is None else max(end, t1)
    span = end - min(float(e["ts"]) for e in kernels) if kernels else 0.0
    counts = {k: sum(frag in e["name"] for e in kernels) for k, frag in KERNEL_FRAGMENTS.items()}
    return counts, len(kernels), busy / span if span > 0 else 0.0


@contextlib.contextmanager
def counting_synchronize():
    """``torch.cuda.synchronize`` wrapped by a counter for the block."""
    calls = [0]
    orig = torch.cuda.synchronize

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    torch.cuda.synchronize = counted
    try:
        yield calls
    finally:
        torch.cuda.synchronize = orig


def obs_local(seed: int, card: str, work: str) -> dict[str, int]:
    """Obs (a) and (b): ``local`` at the train cell (bs16, 9 steps) with
    the plane off (stride 0: no fence, no step family), then armed
    (``--profile-stride 3 --metrics-jsonl --trace-jsonl --profile-dir``):
    the step samples, the post-first-step watermark, the Chrome trace's
    kernels against the launch counters, the device share of a sampled
    step. Returns each kernel's launches over both runs."""
    base = ["local", "--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400",
            "--epochs", "1", "--seed", str(seed)]
    total = zero_launches()
    # (b) first: no step family may exist yet in this process.
    check(not any(f in obs_mod.default_registry().snapshot()["families"] for f in STEP_FAMILIES),
          "a step family was registered before any profiled run")
    zero_with_fold()
    with counting_synchronize() as syncs:
        res = run_local(build_parser().parse_args(base + ["--output-dir", os.path.join(work, "obs-b")]))
    launches = read_with_fold()
    fams = obs_mod.default_registry().snapshot()["families"]
    print(f"obs (b): stride 0: {res['state'].step} steps, torch.cuda.synchronize calls {syncs[0]}, step families "
          f"{[f for f in STEP_FAMILIES if f in fams]}, launches {launches}", flush=True)
    check(syncs[0] == 0, f"stride 0 made {syncs[0]} torch.cuda.synchronize calls")
    check(not any(f in fams for f in STEP_FAMILIES), "stride 0 registered a step family")
    check(res["trainer"].step_profiler is None, "stride 0 built a step profiler")
    add_launches(total, launches)

    # (a) the plane armed; the trace's window is the fit.
    prof_dir = os.path.join(work, "obs-prof")
    metrics_path, trace_path = os.path.join(work, "obs-local.jsonl"), os.path.join(work, "obs-local-spans.jsonl")
    window: dict[str, int] = {}
    orig_trace = profiling_mod.trace

    @contextlib.contextmanager
    def counted_trace(log_dir):
        counts_zero()
        with orig_trace(log_dir):
            yield
        window.update(counts_read())

    before = {p: registry_value("fedtpu_train_step_seconds", {"phase": p}) for p in ("host", "dispatch", "device")}
    torch.cuda.reset_peak_memory_stats()
    zero_with_fold()
    profiling_mod.trace = counted_trace
    try:
        res = run_local(build_parser().parse_args(base + [
            "--output-dir", os.path.join(work, "obs-a"), "--profile-stride", "3", "--metrics-jsonl", metrics_path,
            "--trace-jsonl", trace_path, "--profile-dir", prof_dir,
        ]))
    finally:
        profiling_mod.trace = orig_trace
        obs_mod.set_profile_stride(0)
        obs_mod.set_global_tracer(None)
    launches = read_with_fold()
    max_alloc = torch.cuda.max_memory_allocated()
    add_launches(total, launches)
    steps = res["state"].step
    summary = res["trainer"].step_profiler.summary()
    counted = {p: registry_value("fedtpu_train_step_seconds", {"phase": p}) - before[p] for p in before}
    print(f"obs (a): {card}: {steps} steps at stride 3: samples {({p: s['n'] for p, s in summary.items()})}, "
          f"fedtpu_train_step_seconds counts {counted}", flush=True)
    check(steps == 9, f"{steps} steps, want 9")
    check(all(summary.get(p, {}).get("n") == 3 for p in before) and all(c == 3 for c in counted.values()),
          f"step samples {summary}, histogram counts {counted}: want 3 of each phase")
    mem = obs_mod.memory_report().get("post-first-step", {})
    print(f"obs (a): {card}: post-first-step watermark: in use {mem.get('bytes_in_use', 0) / 1e6:.1f} MB, peak "
          f"{mem.get('peak_bytes', 0) / 1e6:.1f} MB (torch.cuda.max_memory_allocated over the run "
          f"{max_alloc / 1e6:.1f} MB)", flush=True)
    check(mem.get("available") and 0 < mem["peak_bytes"] <= max_alloc, f"post-first-step watermark {mem}")
    in_trace, n_kernels, busy = trace_kernel_counts(prof_dir)
    want = {"K1": window["flash_fwd"] + window["flash_fwd_dropout"], "K2": window["flash_bwd_dkdv"],
            "K3": window["flash_bwd_dq"]}
    print(f"obs (a): torch.profiler trace of the fit: {n_kernels} CUDA kernel events; K1/K2/K3 in the trace {in_trace}, "
          f"launch counters over the same window {want}; device busy share from the first kernel to the last "
          f"{busy:.3f} (under the profiler's own host cost)", flush=True)
    check(in_trace == want, f"the trace's K1/K2/K3 kernels {in_trace} != the launch counters {want}")
    p50 = {p: summary[p]["p50"] * 1e3 for p in ("host", "dispatch", "device")}
    p95 = {p: summary[p]["p95"] * 1e3 for p in ("host", "dispatch", "device")}
    share = p50["device"] / sum(p50.values())
    print(f"obs (a): {card}: sampled train step (bs16, flash, bf16) p50 host {p50['host']:.3f} ms, dispatch "
          f"{p50['dispatch']:.3f} ms, device {p50['device']:.3f} ms (p95 {p95['host']:.3f} / {p95['dispatch']:.3f} / "
          f"{p95['device']:.3f} ms): device share of the sampled step {share:.3f}", flush=True)
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    check([r["phase"] for r in recs] == ["val", "test"] and all(np.isfinite(r["Loss"]) for r in recs),
          f"metrics records {recs}")
    check(all(r["schema"] == "fedtpu-metrics-v1" and r["run_id"] for r in recs), "metrics records lack schema/run_id")
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == 6 * steps,
          f"K1-dropout/K2/K3 launches {launches} for {steps} steps")

    # The same fit at stride 1 without --profile-dir: every step's split
    # with no torch.profiler running (the trace's own host cost inflates
    # the dispatch above).
    zero_with_fold()
    try:
        res = run_local(build_parser().parse_args(base + ["--output-dir", os.path.join(work, "obs-a1"), "--profile-stride", "1"]))
    finally:
        obs_mod.set_profile_stride(0)
    add_launches(total, read_with_fold())
    summary = res["trainer"].step_profiler.summary()
    p50 = {p: summary[p]["p50"] * 1e3 for p in ("host", "dispatch", "device")}
    share = p50["device"] / sum(p50.values())
    print(f"obs (a): {card}: the same fit at stride 1, no profiler: {summary['device']['n']} samples, p50 host "
          f"{p50['host']:.3f} ms, dispatch {p50['dispatch']:.3f} ms, device {p50['device']:.3f} ms: device share {share:.3f}",
          flush=True)
    check(summary["device"]["n"] == 9, f"stride 1 sampled {summary['device']['n']} of 9 steps")
    return total


def obs_profile(card: str, work: str) -> dict[str, int]:
    """Obs (c): ``obs profile --preset distilbert --steps 12 --capture DIR
    --json`` through the port's CLI."""
    cap = os.path.join(work, "obs-capture")
    zero_with_fold()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["obs", "profile", "--preset", "distilbert", "--steps", "12", "--capture", cap, "--json"])
    launches = read_with_fold()
    rep = json.loads(out.getvalue())
    check(rc == 0, f"obs profile exited {rc}: {rep}")
    step = rep["step"]
    step_s = sum(step[p]["p50"] for p in ("host", "dispatch", "device"))
    peak = profiling_mod.device_peak_flops()
    flops = rep["flops_analytic"]
    mfu = profiling_mod.mfu(flops, step_s)
    lo, hi = rep["flops_tolerance"]
    print(f"obs (c): {card}: FLOPs counted {rep['flops_xla']:.6g} vs analytic {flops:.6g}: ratio {rep['flops_ratio']} "
          f"(tolerance {lo}-{hi}, ok {rep['flops_ratio_ok']})", flush=True)
    print(f"obs (c): {card}: sampled step (bs8, flash, bf16) p50 host {step['host']['p50'] * 1e3:.3f} ms, dispatch "
          f"{step['dispatch']['p50'] * 1e3:.3f} ms, device {step['device']['p50'] * 1e3:.3f} ms ({step['device']['n']} "
          f"samples): MFU {mfu if mfu is None else round(mfu, 4)} of {peak} FLOP/s peak", flush=True)
    print(f"obs (c): {card}: peak_device_bytes {rep['peak_device_bytes'] / 1e6:.1f} MB, compile_count "
          f"{rep['compile_count']} ({rep['sites']}), serving storm {rep['serving']}; launches {launches}", flush=True)
    check(rep["flops_ratio_ok"] and lo < rep["flops_ratio"] < hi, f"FLOPs ratio {rep['flops_ratio']}")
    check(step["device"]["n"] == 12 and rep["recompiles"] == [], f"profiled steps {step}, recompiles {rep['recompiles']}")
    check(rep["serving"]["recompiles"] == 0, f"the serving storm recompiled: {rep['serving']}")
    check(rep["peak_device_bytes"] > 0, "no device watermark in the profile")
    _, n_kernels, busy = trace_kernel_counts(cap)
    print(f"obs (c): the capture: {n_kernels} CUDA kernel events, device busy share {busy:.3f}", flush=True)
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == 6 * 15,
          f"K1-dropout/K2/K3 launches {launches} for 2 warmup + 1 counted + 12 profiled steps")
    return launches


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scrape(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def obs_round(seed: int, card: str, work: str) -> dict[str, int]:
    """Obs (d): ``serve --num-clients 2 --trace-jsonl --metrics-port`` and
    two ``client --trace-jsonl`` at the round cell, fold on the card."""
    spans = os.path.join(work, "obs-spans")
    mport = free_port()
    names = ("fedtpu_server_rounds_total", "fedtpu_server_wire_bytes_received_total",
             "fedtpu_server_wire_bytes_sent_total")
    before = {n: registry_value(n) for n in names}
    server = build_round_server(build_parser().parse_args(
        ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--timeout", "600", "--device", "cuda",
         "--trace-jsonl", os.path.join(spans, "server.jsonl"), "--metrics-port", str(mport)]
    ))
    results: dict[int, dict] = {}
    errors: list[BaseException] = []

    def client(i: int) -> None:
        try:
            results[i] = run_client(build_parser().parse_args(
                ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
                 "--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400", "--epochs", "1",
                 "--rounds", "1", "--seed", str(seed), "--timeout", "600", "--output-dir", os.path.join(work, "obs-d"),
                 "--trace-jsonl", os.path.join(spans, f"client{i}.jsonl"), "--profile-stride", "3"]
            ))
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    zero_with_fold()
    with server:
        st = threading.Thread(target=server.serve, args=(1,))
        workers = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in (st, *workers):
            t.start()
        for t in (*workers, st):
            t.join(timeout=900)
        check(not any(t.is_alive() for t in (st, *workers)), "round threads hung")
        if errors:
            raise errors[0]
        text = scrape(mport, "/metrics").decode()
        doc = json.loads(scrape(mport, "/metrics.json"))
    launches = read_with_fold()
    obs_mod.set_profile_stride(0)
    check(server.metrics_server is None, "the server left its /metrics endpoint open")

    def text_value(name: str) -> float:
        lines = [ln for ln in text.splitlines() if ln.startswith(name + " ")]
        check(len(lines) == 1, f"/metrics renders {name} {len(lines)} times")
        return float(lines[0].rsplit(" ", 1)[1])

    fams = doc["families"]
    moved = {n: text_value(n) - before[n] for n in names}
    check(all(fams[n]["samples"][0]["value"] == text_value(n) for n in names), "/metrics.json disagrees with /metrics")
    up = sum(results[i]["exchange"]["upload_bytes"] for i in range(2))
    down = sum(results[i]["exchange"]["reply_bytes"] for i in range(2))
    print(f"obs (d): /metrics over the round: rounds_total +{moved[names[0]]:.0f}, bytes received "
          f"+{moved[names[1]]:.0f} (the clients sent {up}), bytes sent +{moved[names[2]]:.0f} (the clients "
          f"received {down}); the same numbers on /metrics.json", flush=True)
    check(moved[names[0]] == 1, f"fedtpu_server_rounds_total moved by {moved[names[0]]}")
    check(moved[names[1]] == up and moved[names[2]] == down, f"byte counters {moved} vs the wire's {up} / {down}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli_main(["obs", "timeline", "--trace-dir", spans, "--json"]) == 0, "obs timeline failed")
    (rnd,) = json.loads(out.getvalue())
    for proc, row in sorted(rnd["clients"].items()):
        err = abs(row["attributed_s"] - row["measured_s"]) / row["measured_s"]
        print(f"obs (d): {card}: {proc}: compute {row['compute_s']:.3f} s, upload {row['upload_s']:.3f} s, wait "
              f"{row['wait_s']:.3f} s, agg {row['agg_s']:.3f} s, reply {row['reply_s']:.3f} s; attributed "
              f"{row['attributed_s']:.3f} s of {row['measured_s']:.3f} s measured ({err:.1%} off)", flush=True)
        check(err < 0.10, f"{proc}: the timeline attributes {row['attributed_s']} s of {row['measured_s']} s")
    check(len(rnd["clients"]) == 2 and rnd["contributors"] == [0, 1], f"timeline round {rnd}")
    for s in obs_mod.load_spans(trace_dir=spans):
        if s["span"] == "client-local" or (s["span"] in ("wire-upload", "wire-reply") and s.get("step_wire_ms_p50")):
            attrs = {k: v for k, v in s.items() if k.startswith("step_")}
            print(f"obs (d): {card}: {s['proc']} {s['span']} {s['dur_s']:.3f} s, sampled step attrs {attrs}", flush=True)
    stats = server.last_fold_stats
    print(f"obs (d): {card}: round wall {rnd['round_wall_s']:.3f} s, agg span {rnd['agg_s']:.3f} s, reply "
          f"{rnd['reply_s']:.3f} s; K4 launches {launches['fold']} (fold of {stats['early_bytes'] + stats['late_bytes']} "
          f"bytes, {stats['overlap_frac']:.0%} during the wire phase, the rest inside the agg span)", flush=True)
    check(launches["fold"] == 102, f"K4 launched {launches['fold']} times in the traced round, want 102")
    steps = sum(results[i]["state"].step for i in range(2))
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == 6 * steps,
          f"K1-dropout/K2/K3 launches {launches} for {steps} steps")
    return launches


def obs_serving(seed: int, card: str, work: str) -> dict[str, int]:
    """Obs (e): ``infer-serve --metrics-port --trace-sample 0.25
    --scored-jsonl --flight-dir`` (and ``--trace-jsonl``) over 64 flows at
    full width, then a reload frame."""
    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(vocab_size=len(tok.vocab), attention_impl="flash", compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(seed + 41))
    reg = os.path.join(work, "obs-registry")
    publish(reg, params, 1, cfg)
    scored, spans, flight = (os.path.join(work, n) for n in ("obs-scored.jsonl", "obs-serve.jsonl", "obs-flight"))
    texts = [flow_to_text(r) for r in flow_records(seed + 42, OBS_FLOWS)]
    before = registry_value("fedtpu_serve_scored_total")
    zero_with_fold()
    server = build_server(build_parser().parse_args(serve_args(
        "--registry-dir", reg, "--reload-poll", "3600", "--metrics-port", "0", "--trace-sample", "0.25",
        "--scored-jsonl", scored, "--flight-dir", flight, "--trace-jsonl", spans, "--profile-stride", "2",
    )))
    with server:
        replies = score_texts(server.port, texts)
        batches = fetch_stats("127.0.0.1", server.port)["batches"]
        new_params = {n: t.clone() for n, t in params.items()}
        new_params["classifier.bias"] = new_params["classifier.bias"] + torch.tensor([2.0, -2.0])
        publish(reg, new_params, 2, cfg)
        with ScoringClient("127.0.0.1", server.port) as c:
            reload = c.reload()
            after = [c.score(text=t) for t in texts[:8]]
        stats = fetch_stats("127.0.0.1", server.port)
        counts, events = server.engine.compile_counts, server.engine.ledger.recompiles()
        score = server.engine.step_profiler.summary()
    obs_mod.set_profile_stride(0)
    obs_mod.set_global_tracer(None)
    obs_mod.set_global_recorder(None)
    launches = read_with_fold()
    n_scored = registry_value("fedtpu_serve_scored_total") - before
    with open(scored) as f:
        rows = [json.loads(line) for line in f]
    serve_spans = [s for s in obs_mod.load_spans([spans]) if s["span"] == "serve-batch"]
    print(f"obs (e): {card}: {OBS_FLOWS} flows in {batches} batches: fedtpu_serve_scored_total +{n_scored:.0f} "
          f"(then {len(after)} after the reload), {len(rows)} scored rows, {len(serve_spans)} serve-batch spans at "
          f"stride 4 over {stats['batches']} batches; ledger {counts}, recompiles {events}; reload {reload}", flush=True)
    p50 = {ph: score[ph]["p50"] * 1e3 for ph in ("host", "dispatch", "device")}
    print(f"obs (e): {card}: sampled score dispatches (every 2nd, {score['device']['n']} samples, warmup included) p50 "
          f"host {p50['host']:.3f} ms, dispatch {p50['dispatch']:.3f} ms, device {p50['device']:.3f} ms: device share "
          f"{p50['device'] / sum(p50.values()):.3f}", flush=True)
    check(n_scored == OBS_FLOWS + len(after), f"fedtpu_serve_scored_total moved by {n_scored}")
    check(len(rows) == OBS_FLOWS + len(after), f"{len(rows)} scored rows")
    # Ids are per connection: the rows and the replies are held as
    # multisets of (id, prob).
    want_rows = collections.Counter((str(r["id"]), round(r["prob"], 6)) for r in replies + after)
    check(collections.Counter((r["rid"], r["prob"]) for r in rows) == want_rows, "the scored rows differ from the replies")
    check(len(serve_spans) == -(-stats["batches"] // 4) and all(s["sampled_batches"] == 4 for s in serve_spans),
          f"{len(serve_spans)} serve-batch spans for {stats['batches']} batches at stride 4")
    check(counts == {(b, cfg.max_len): 1 for b in BUCKETS} and events == [], f"ledger {counts}, recompiles {events}")
    check(reload["reloaded"] is True and reload["round"] == 2, f"reload reply {reload}")
    bundles = os.listdir(flight) if os.path.isdir(flight) else []
    check(not bundles, f"flight bundles {bundles} from a clean run")
    check(launches["flash_fwd"] == cfg.n_layers * (len(BUCKETS) + stats["batches"]),
          f"K1 launched {launches['flash_fwd']} times for {len(BUCKETS)} warmups + {stats['batches']} batches")
    return launches


def obs_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 12: the obs layer on the card, (a)-(e). Returns each kernel's
    launches during it."""
    t0 = time.perf_counter()
    total = zero_launches()
    with tempfile.TemporaryDirectory() as work:
        add_launches(total, obs_local(seed, card, work))
        add_launches(total, obs_profile(card, work))
        add_launches(total, obs_round(seed, card, work))
        add_launches(total, obs_serving(seed, card, work))
    print(f"obs: launches {total}; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------- slice 13
CANARIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "canary_flows.jsonl")
CONTROL_FLOWS = 80  # served between the SLO check's two polls, then labelled
CONTROL_CLIENT_ARGS = ["--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "2400",
                       "--epochs", "1", "--rounds", "2", "--timeout", "600"]
# "99% of requests wait <= 1 ms in the scorer's queue": the micro-batcher's
# 5 ms gather window breaches it on any traffic.
CONTROL_SLO = [{"name": "scoring-queue-1ms", "metric": "fedtpu_serve_queue_wait_seconds", "kind": "latency",
                "le": 0.001, "objective": 0.99, "windows": [[600.0, 1.0], [60.0, 1.0]]}]
# "90% of rounds close within 1 s": round 0 (two clients' start-up,
# training and a 172 MB exchange each way) breaches it, and the
# controller's actuator halves round 1's straggler deadline.
ROUND_SLO = [{"name": "round-duration", "metric": "fedtpu_server_round_seconds", "kind": "latency", "le": 1.0,
              "objective": 0.9, "windows": [[600.0, 1.0], [60.0, 1.0]]}]


def wait_for(cond, seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        check(time.monotonic() < deadline, f"timed out after {seconds:.0f} s waiting for {what}")
        time.sleep(0.05)


def cli_json(argv: list[str]) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def round_mean(uploads: list[dict]) -> dict[str, np.ndarray]:
    """The unweighted round's mean by :func:`numpy_fold`, leaf by leaf, in
    client order."""
    flats = [wire.flatten_params(u) for u in uploads]
    w = np.full(len(flats), 1.0 / len(flats))
    return {key: numpy_fold([np.asarray(f[key], np.float32) for f in flats], w) for key in flats[0]}


def control_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 12: the watched deployment loop on the card. ``controller``
    with two ``client``s of the train cell for two rounds, ``infer-serve``
    following the registry, ``obs health`` over both daemons, and ``obs
    sentinel``'s canaries and journal tail, whose supervised-drift verdict
    starts the second round. Returns each kernel's launches during it."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        p = {n: os.path.join(work, n) for n in (
            "ctl-spans.jsonl", "serve-metrics.jsonl", "scored.jsonl", "labels.jsonl", "verdicts.jsonl",
            "alerts.jsonl", "paged.jsonl", "ring.jsonl", "sentinel-spans.jsonl", "slo.json", "round-slo.json",
            "round-alerts.jsonl")}
        for name, slo in (("slo.json", CONTROL_SLO), ("round-slo.json", ROUND_SLO)):
            with open(p[name], "w") as f:
                json.dump(slo, f)
        reg = os.path.join(work, "registry")
        cport, sport = free_port(), free_port()
        run = build_controller(build_parser().parse_args([
            "controller", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--rounds", "2",
            "--registry-dir", reg, "--drift-jsonl", p["serve-metrics.jsonl"], "--sentinel-jsonl", p["verdicts.jsonl"],
            # The clock stays the fallback; random weights give no accuracy
            # order, so the gate passes any finite candidate.
            "--max-interval", "900", "--gate-min-delta", "100", "--metrics-port", str(cport),
            "--round-deadline", "600", "--slo-alerts-jsonl", p["round-alerts.jsonl"],
            "--trace-jsonl", p["ctl-spans.jsonl"], "--timeout", "600", "--seed", str(seed),
            *CONTROL_CLIENT_ARGS[:6], "--device", "cuda",
        ]))
        ctl, eval_bs = run.controller, run.cfg.data.eval_batch_size
        check(run.trainer.device.type == "cuda" and run.server.device.type == "cuda",
              f"gate on {run.trainer.device}, fold on {run.server.device}")
        mcfg = run.cfg.model
        check((mcfg.dim, mcfg.n_layers, mcfg.attention_impl, mcfg.compute_dtype) == (768, 6, "flash", "bfloat16"),
              f"not full width: {mcfg}")
        # Measurement wrappers: the gate's seconds and its K1 launches (the
        # controller thread's own), the registry add's seconds.
        tally, gates, split = threading.local(), [], collections.defaultdict(list)
        launch, eval_fn, add = flash_mod._launch_fwd, ctl.eval_fn, ctl.registry.add

        def counted_launch(q, k, v, bias, seed_words, rate):
            out = launch(q, k, v, bias, seed_words, rate)
            if rate == 0.0:
                tally.k1 = getattr(tally, "k1", 0) + 1
            return out

        def timed_eval(params):
            t0, k0 = time.perf_counter(), getattr(tally, "k1", 0)
            m = eval_fn(params)
            torch.cuda.synchronize()
            split["gate eval"].append(time.perf_counter() - t0)
            gates.append((m, getattr(tally, "k1", 0) - k0))
            return m

        def timed_add(*a, **kw):
            t0 = time.perf_counter()
            aid = add(*a, **kw)
            split["registry add"].append(time.perf_counter() - t0)
            return aid

        ctl.eval_fn, ctl.registry.add = timed_eval, timed_add
        results: dict[int, dict] = {}
        errors: list[BaseException] = []

        def controller() -> None:
            try:
                with run.server:
                    ctl.run(max_rounds=2)
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        def client(i: int) -> None:
            try:
                results[i] = run_client(build_parser().parse_args(
                    ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(run.server.port),
                     *CONTROL_CLIENT_ARGS, "--seed", str(seed), "--output-dir", os.path.join(work, "clients")]
                ))
            except BaseException as e:
                errors.append(e)

        # The health plane over the controller from before round 0: the
        # round-duration objective fires once round 0 has closed.
        hub = build_hub(build_parser().parse_args([
            "obs", "watch", "--target", f"controller=127.0.0.1:{cport}", "--slo", p["round-slo.json"],
            "--alerts-jsonl", p["round-alerts.jsonl"],
        ]))
        hub_deadline = time.monotonic() + 900
        watcher = threading.Thread(target=hub.watch, kwargs=dict(
            interval_s=0.5, out=io.StringIO(),
            stop=lambda: os.path.exists(p["round-alerts.jsonl"]) or errors or time.monotonic() > hub_deadline,
        ))
        zero_with_fold()
        flash_mod._launch_fwd = counted_launch
        threads = [threading.Thread(target=controller)] + [threading.Thread(target=client, args=(i,)) for i in range(2)]
        try:
            watcher.start()
            for t in threads:
                t.start()
            registry = ModelRegistry(reg)
            wait_for(lambda: registry.serving_info() is not None or errors, 900, "round 0's promotion")
            if errors:
                raise errors[0]
            a0 = registry.serving_info()["artifact"]
            server = build_server(build_parser().parse_args(serve_args(
                "--registry-dir", reg, "--reload-poll", "0.2", "--metrics-port", str(sport),
                "--metrics-jsonl", p["serve-metrics.jsonl"], "--scored-jsonl", p["scored.jsonl"],
            )))
            with server:
                check(server.engine.device.type == "cuda", f"engine on {server.engine.device}")
                # (b) the hub over the two daemons, then an objective the
                # traffic between its polls breaches.
                rc, out = cli_json(["obs", "health", "--json", "--interval", "0.5",
                                    "--target", f"controller=127.0.0.1:{cport}",
                                    "--target", f"infer-serve=127.0.0.1:{sport}"])
                verdict = json.loads(out)
                print(f"control (b): {card}: obs health exit {rc}: {verdict['targets_up']}/{verdict['targets']} up, "
                      f"{len(verdict['slo_firing'])} firing, scrape lag {verdict['scrape_lag_ms']} ms", flush=True)
                check(rc == 0 and verdict["schema"] == "fedtpu-health-v1" and verdict["healthy"]
                      and verdict["targets_up"] == 2, f"obs health: exit {rc}, {verdict}")
                texts = [flow_to_text(r) for r in flow_records(seed + 61, CONTROL_FLOWS)]
                replies: list[dict] = []

                def traffic() -> None:
                    time.sleep(0.5)
                    with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
                        replies.extend(c.score(text=t) for t in texts)

                sender = threading.Thread(target=traffic)
                sender.start()
                rc2, screen = cli_json(["obs", "health", "--interval", "3", "--slo", p["slo.json"],
                                        "--target", f"infer-serve=127.0.0.1:{sport}", "--alerts-jsonl", p["alerts.jsonl"],
                                        "--alert-cmd", f"cat >> {p['paged.jsonl']}", "--alert-interval", "0"])
                sender.join(timeout=120)
                with open(p["alerts.jsonl"]) as f:
                    alerts = [json.loads(line) for line in f]
                wait_for(lambda: os.path.exists(p["paged.jsonl"]) and open(p["paged.jsonl"]).read().endswith("\n"),
                         10, "the --alert-cmd run")
                with open(p["paged.jsonl"]) as f:
                    paged = [json.loads(line) for line in f]
                print(f"control (b): --slo {CONTROL_SLO[0]['name']}: exit {rc2}, alerts "
                      f"{[(a['event'], a['slo'], a['burn']) for a in alerts]}, --alert-cmd runs {len(paged)}", flush=True)
                check(rc2 == 1 and "FIRING" in screen, f"obs health --slo: exit {rc2}")
                check(len(alerts) == 1 and alerts[0]["schema"] == "fedtpu-alert-v1" and alerts[0]["event"] == "fire"
                      and alerts[0]["slo"] == CONTROL_SLO[0]["name"], f"alerts {alerts}")
                check(paged == alerts, f"--alert-cmd got {paged}")
                check(len(replies) == CONTROL_FLOWS and {r["round"] for r in replies} == {0},
                      f"infer-serve answered rounds {sorted({r['round'] for r in replies})} before round 1")
                # (c) the sentinel: canaries at a fixed artifact, then the
                # journal tail's verdict, which starts round 1.
                sentinel = build_sentinel(build_parser().parse_args([
                    "obs", "sentinel", "--canaries", CANARIES, "--canary-preset", "cicids2017",
                    "--serve", f"127.0.0.1:{server.port}", "--registry-dir", reg, "--ring-jsonl", p["ring.jsonl"],
                    "--trace-jsonl", p["sentinel-spans.jsonl"], "--scored-jsonl", p["scored.jsonl"],
                    "--labels-journal", p["labels.jsonl"], "--reference-error", "0.05",
                    "--verdicts-jsonl", p["verdicts.jsonl"],
                ]))
                probe, probed = sentinel.prober._probe_fn, []

                def recording_probe(*a, **kw):
                    rows = probe(*a, **kw)
                    probed.append(rows)
                    return rows

                sentinel.prober._probe_fn = recording_probe
                n_canaries = len(sentinel.prober.flows)
                lat_before = registry_value("fedtpu_canary_latency_seconds")
                reports = [sentinel.tick() for _ in range(3)]
                with open(p["labels.jsonl"], "w") as f:  # delayed truth: every served flow was misjudged
                    for r in replies:
                        f.write(json.dumps({"schema": "fedtpu-label-v1", "rid": str(r["id"]),
                                            "label": 1 - int(r["prediction"]), "ts": time.time()}) + "\n")
                    f.write(json.dumps({"schema": "fedtpu-label-v1", "watermark": time.time()}) + "\n")
                reports.append(sentinel.tick())
                check(reports[-1]["drift"]["verdict"] is not None, f"no supervised-drift verdict: {reports[-1]['drift']}")
                wait_for(lambda: (registry.serving_info() or {}).get("round") == 1 or errors, 900, "round 1's promotion")
                if errors:
                    raise errors[0]
                with ScoringClient("127.0.0.1", server.port, timeout=120) as c:
                    deadline = time.monotonic() + 120
                    while c.score(text=texts[0])["round"] != 1:
                        check(time.monotonic() < deadline, "the scorer never swapped to round 1")
                        time.sleep(0.01)
                    t_first = time.time()
                    after = [c.score(text=t) for t in texts[:8]]
                reports += [sentinel.tick() for _ in range(3)]
            for t in threads:
                t.join(timeout=900)
            watcher.join(timeout=60)
        finally:
            flash_mod._launch_fwd = launch
        check(not any(t.is_alive() for t in (*threads, watcher)), "controller, client or hub threads hung")
        if errors:
            raise errors[0]
        launches = read_with_fold()
        obs_mod.set_global_tracer(None)
        obs_mod.set_profile_stride(0)

        # (a) the campaign's records: bootstrap, the sentinel's verdict, round 1.
        with open(os.path.join(reg, "controller_state.jsonl")) as f:
            events = [json.loads(line) for line in f]
        print(f"control (a): state records {[(e['event'], e.get('round'), e.get('trigger'), e.get('method')) for e in events]}",
              flush=True)
        check([(e["event"], e.get("round"), e.get("trigger")) for e in events] == [
            ("promoted", 0, "bootstrap"), ("drift_trigger", None, None), ("promoted", 1, "drift")],
            f"state records {events}")
        check(events[1]["method"] == "error_rate" and events[1]["error"] == 1.0, f"drift trigger {events[1]}")
        with open(p["round-alerts.jsonl"]) as f:
            round_alerts = [json.loads(line) for line in f]
        print(f"control (b): round-duration objective: {[(a['event'], a['burn']) for a in round_alerts]} after "
              f"{hub.polls} polls; round 1's record slo_tightened {events[2].get('slo_tightened')}", flush=True)
        check([a["event"] for a in round_alerts] == ["fire"] and events[2].get("slo_tightened") is True
              and "slo_tightened" not in events[0], f"round-duration alerts {round_alerts}, records {events}")
        spans = obs_mod.load_spans([p["ctl-spans.jsonl"]])
        # The controller's promote span (shadow, then serving); the
        # registry's own carry the state they moved to.
        promote = {s["round"]: s for s in spans if s["span"] == "promote" and "state" not in s}
        check(len(gates) == 2 and all(ev["artifact"] for ev in events[::2]), f"{len(gates)} gate evaluations")
        k1_gate = mcfg.n_layers * -(-len(run.val.input_ids) // eval_bs)
        for r, ev in ((0, events[0]), (1, events[2])):
            m = registry.manifest(ev["artifact"])
            params = registry.load_params(m["id"])
            want = round_mean([results[i]["rounds"][r]["uploaded"] for i in range(2)])
            bitexact = params.keys() == want.keys() and all(np.array_equal(params[k], want[k]) for k in want)
            gate, gate_k1 = gates[r]
            again = run.trainer.evaluate(wire.unflatten_params(params), run.val, batch_size=eval_bs)
            scalars = {k: float(v) for k, v in again.items() if k in ("Accuracy", "Loss", "Precision", "Recall", "F1-Score")}
            hist = reference_histogram(gate["probs"]).tolist()
            print(f"control (a): {card}: round {r}: artifact {m['id']} bit-equal to numpy's fold of the uploads: "
                  f"{bitexact}; gate {scalars} (re-evaluated on the card: equal {all(m['metrics'][k] == v for k, v in scalars.items())}); "
                  f"eval_hist {m['eval_hist']}; gate K1 launches {gate_k1} (want {k1_gate}); cycle: round wall "
                  f"{ev['round_wall_s']:.3f} s, gate eval {split['gate eval'][r]:.3f} s, registry add "
                  f"{split['registry add'][r]:.3f} s, promote {promote[r]['dur_s']:.4f} s", flush=True)
            check(bitexact and m["id"] == artifact_id(want), f"round {r}: artifact {m['id']} is not the fold of the uploads")
            check(all(m["metrics"][k] == v for k, v in scalars.items()), f"round {r}: gate {m['metrics']} vs {scalars}")
            check(m["eval_hist"] == hist and hist == reference_histogram(again["probs"]).tolist(),
                  f"round {r}: eval_hist {m['eval_hist']} vs {hist}")
            check(gate_k1 == k1_gate, f"round {r}: the gate launched K1 {gate_k1} times, want {k1_gate}")
            check(m["parent"] == (None if r == 0 else events[0]["artifact"]), f"round {r}: parent {m['parent']}")
        a1 = events[2]["artifact"]
        t_promote = promote[1]["ts"] + promote[1]["dur_s"]
        print(f"control (a): {card}: promotion latency (promote -> first reply of round 1) "
              f"{t_first - t_promote:.3f} s; replies after it name rounds {sorted({r['round'] for r in after})}", flush=True)
        check({r["round"] for r in after} == {1}, "infer-serve did not follow round 1's promotion")
        check(launches["fold"] == 2 * 102, f"K4 launched {launches['fold']} times in two rounds, want 204")
        steps = sum(results[i]["state"].step for i in range(2))
        check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"]
              == mcfg.n_layers * steps, f"K1-dropout/K2/K3 launches {launches} for {steps} client steps")

        # (c) the sentinel's ticks: a fixed artifact, then across round 1.
        canary = [s for s in obs_mod.load_spans([p["sentinel-spans.jsonl"]]) if s["span"] == "canary-probe"]
        incidents = [i for rep in reports for i in rep["canary"]["incidents"]]
        buckets = [[reply.get("bucket") for reply, _ in rows] for rows in probed]
        probs = [[reply["prob"] for reply, _ in rows] for rows in probed]
        lat = sorted(s * 1e3 for rows in probed for _, s in rows)
        n_lat = registry_value("fedtpu_canary_latency_seconds") - lat_before
        print(f"control (c): {card}: {len(reports)} ticks over artifacts {[s['artifact'] for s in canary]}; "
              f"buckets per tick {buckets}; incidents {incidents}; canary p50 {lat[len(lat) // 2]:.3f} ms, p99 "
              f"{lat[max(0, int(len(lat) * 0.99) - 1)]:.3f} ms; latency histogram +{n_lat:.0f}", flush=True)
        check([s["artifact"] for s in canary] == [a0] * 4 + [a1] * 3, "canary ticks' artifacts")
        check(not incidents and all(s["mismatches"] == s["flips"] == 0 for s in canary), f"incidents {incidents}")
        check(all(row == probs[0] for row in probs[:4]) and all(row == probs[4] for row in probs[4:]),
              "a canary's score moved at a fixed artifact")
        check(n_lat == n_canaries * len(reports), f"fedtpu_canary_latency_seconds +{n_lat}, want {n_canaries} x {len(reports)}")
        check(reports[-1]["counters"] == {"canary_flips": 0, "drift_fires": 1, "regression_fires": 0},
              f"sentinel counters {reports[-1]['counters']}")
    print(f"control: launches {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------- slice 11
def zero_launches() -> dict[str, int]:
    return {k: 0 for k in ("flash_fwd", "flash_fwd_dropout", "flash_bwd_dkdv", "flash_bwd_dq", "fold")}


def add_launches(total: dict[str, int], more: dict[str, int]) -> None:
    for k, v in more.items():
        total[k] += v


def read_with_fold() -> dict[str, int]:
    return {**counts_read(), "fold": fold_mod.FOLD_LAUNCHES}


def zero_with_fold() -> None:
    """Every launch counter to 0, K4's included (``counts_zero`` leaves it)."""
    counts_zero()
    fold_mod.FOLD_LAUNCHES = 0


def hf_verbs_check(seed: int, card: str, work: str, hf: str, pth: str) -> dict[str, int]:
    """The ``--hf-dir`` verbs the migrate phase owed a card run: ``client
    --hf-dir`` in a one-round ``serve --num-clients 2``, ``federated
    --hf-dir`` for one round, ``distill --hf-dir`` (the encoder warm-starts
    a 6-layer teacher, a 3-layer student) and ``distill --hf-dir --pth``
    (the .pth is the teacher). Each with finite losses; returns their
    launches (K4's under ``fold``)."""
    flags = ["--preset", "distilbert", "--attention-impl", "flash", "--hf-dir", hf, "--seed", str(seed)]
    total = zero_launches()
    zero_with_fold()
    with tempfile.TemporaryDirectory() as out_dir:
        server = build_round_server(build_parser().parse_args(
            ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--timeout", "600"]
        ))
        check(server.device.type == "cuda", f"server folds on {server.device}")
        results, errors = {}, []

        def client(i: int) -> None:
            try:
                results[i] = run_client(build_parser().parse_args(
                    ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port), *flags,
                     "--synthetic", "1200", "--epochs", "1", "--rounds", "1", "--timeout", "600", "--output-dir", out_dir]
                ))
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        with server:
            threads = [threading.Thread(target=server.serve, args=(1,))] + [threading.Thread(target=client, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
        check(not any(t.is_alive() for t in threads), "client --hf-dir round threads hung")
        if errors:
            raise errors[0]
    got = read_with_fold()
    add_launches(total, got)
    L = results[0]["config"].model.n_layers
    steps = [results[i]["state"].step for i in range(2)]
    aggs = [wire.flatten_params(results[i]["aggregate"]) for i in range(2)]
    same = all(np.array_equal(aggs[0][k], aggs[1][k]) for k in aggs[0])
    finite = all(np.isfinite(v).all() for v in aggs[0].values())
    print(f"migrate: {card}: client --hf-dir x2 in one serve round: {steps} steps, K4 {got['fold']} launches, "
          f"both aggregates equal {same}, finite {finite}; launches {got}", flush=True)
    check(results[0]["config"].model.dim == 768 and got["fold"] == 102 and same and finite, "client --hf-dir round")
    check(got["flash_fwd_dropout"] == got["flash_bwd_dq"] == L * sum(steps), f"client --hf-dir launches {got}")

    zero_with_fold()
    res = run_federated(build_parser().parse_args(
        ["federated", *flags, "--synthetic", "1200", "--num-clients", "2", "--rounds", "1", "--epochs", "1",
         "--output-dir", os.path.join(work, "m_fed")]
    ))
    got = read_with_fold()
    add_launches(total, got)
    losses = res["history"][0].epoch_losses
    steps = sum(-(-int(n) // 16) for n in res["stacked_train"].n_rows)
    print(f"migrate: {card}: federated --hf-dir: 1 round, {steps} client-steps, epoch losses {np.round(losses, 4).tolist()}; "
          f"launches {got}", flush=True)
    check(res["trainer"].device.type == "cuda" and res["config"].model.dim == 768 and np.isfinite(losses).all(), "federated --hf-dir")
    check(got["flash_fwd_dropout"] == L * steps, f"federated --hf-dir K1-dropout launches {got}")
    del res

    for name, extra in (("distill --hf-dir", ["--teacher-layers", "6"]), ("distill --hf-dir --pth", ["--pth", pth])):
        zero_with_fold()
        res = run_distill(build_parser().parse_args(
            ["distill", *flags, *extra, "--student-layers", "3", "--synthetic", "1200",
             "--output-dir", os.path.join(work, "m_distill")]
        ))
        got = read_with_fold()
        add_launches(total, got)
        losses = np.asarray(res["losses"], np.float64)
        t_losses = res["teacher_losses"]
        print(f"migrate: {card}: {name}: teacher {res['teacher_config'].n_layers} layers ({res['teacher_steps']} steps, "
              f"losses {t_losses}), student {res['config'].model.n_layers} layers, KD losses {losses.tolist()}; launches {got}", flush=True)
        check(res["config"].model.dim == 768 and res["teacher_config"].n_layers == 6, f"{name}: teacher {res['teacher_config']}")
        check(np.isfinite(losses).all() and (t_losses is None or np.isfinite(t_losses).all()), f"{name}: non-finite losses")
        check(got["flash_bwd_dkdv"] > 0, f"{name} launched no backward")
        del res
    return total


PRIV_ARGS = ["--synthetic", "1600", "--num-clients", str(FED_CLIENTS), "--partition", "quantity",
             "--dirichlet-alpha", "2.0", "--data-fraction", "0.25"]


def dp_boundary_check(seed: int, card: str) -> None:
    """(a) and (b) of the privacy phase on the card, at full width: four
    clients' round results made from the seeded init plus deltas of L2
    norm 0.25, 0.5, 2 and 4 x the clip (the last two clipped).
    ``FederatedTrainer.aggregate`` at noise 0 against the float64 numpy
    clipped mean; the clipped client alone scaled to the clip exactly;
    the std of (noised - noiseless) over the whole model within 1% of
    ``noise * clip / n``."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        resolve_config,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel import (
        dp as pdp,
    )

    clip, scales = 1.0, np.array([0.25, 0.5, 2.0, 4.0])
    tok = default_tokenizer()
    args = build_parser().parse_args(
        ["federated", "--preset", "distilbert", "--attention-impl", "flash", *PRIV_ARGS, "--dp-clip", str(clip)]
    )
    trainer = FederatedTrainer(resolve_config(args, vocab_size=len(tok.vocab)), pad_id=tok.pad_id, device="cuda")
    state = trainer.init_state(seed=seed)
    anchor = trainer.round_anchor(state)
    g = torch.Generator(device="cuda").manual_seed(seed + 41)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(torch.randn(p.shape, generator=g, device="cuda"))
        norms = pdp.client_update_norms(state.params, anchor)
        f = torch.tensor(scales * clip, device="cuda", dtype=torch.float32) / norms
        for n, p in state.params.items():
            p.copy_(anchor[n] + (p - anchor[n]) * f.view(-1, *([1] * (p.ndim - 1))))
    n_params = sum(p[0].numel() for p in state.params.values())
    deltas = {n: (p.detach() - anchor[n]).double().cpu().numpy() for n, p in state.params.items()}
    norm64 = np.sqrt(sum((d.reshape(FED_CLIENTS, -1) ** 2).sum(axis=1) for d in deltas.values()))
    factor = np.minimum(1.0, clip / norm64) / FED_CLIENTS
    card_norms = pdp.client_update_norms(state.params, anchor).cpu().numpy()
    local = {n: p.detach().clone() for n, p in state.params.items()}
    t0 = time.perf_counter()
    trainer.aggregate(state, anchor=anchor, round_index=0)
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    worst, rows_equal = 0.0, True
    for n, p in state.params.items():
        a64 = anchor[n][0].double().cpu().numpy()
        mean64 = np.tensordot(factor, deltas[n], axes=1)
        got = p[0].detach().double().cpu().numpy()
        # rtol 1e-5 of the terms' magnitude: the clients' deltas may cancel.
        terms = np.abs(a64) + np.tensordot(factor, np.abs(deltas[n]), axes=1)
        ratio = np.abs(got - (a64 + mean64)) / np.maximum(1e-5 * terms, np.finfo(np.float64).tiny)
        worst = max(worst, float(ratio.max()))
        rows_equal = rows_equal and all(torch.equal(p[c], p[0]) for c in range(1, FED_CLIENTS))
    # The clipped client alone: its delta scaled to the clip exactly.
    only = np.array([0.0, 0.0, 0.0, 1.0])
    alone, _ = pdp.dp_fedavg(local, anchor, None, only, clip=clip, noise_multiplier=0.0)
    alone_norm = float(np.sqrt(sum(((alone[n].double() - anchor[n][0].double()) ** 2).sum().item() for n in alone)))
    print(f"privacy: {card}: {FED_CLIENTS} clients x {n_params} parameters; update norms on the card "
          f"{np.round(card_norms, 6).tolist()} (float64 {np.round(norm64, 6).tolist()}), clip {clip}; DP aggregate at noise 0 "
          f"in {agg_s:.3f} s, every row equal {rows_equal}, largest |card - float64 clipped mean| over rtol 1e-5 of the "
          f"terms' magnitude {worst:.3e} (<= 1 passes); the 4x client alone lands at norm {alone_norm:.7f}", flush=True)
    check(rows_equal and worst <= 1.0, f"the card's DP aggregate is {worst} x rtol 1e-5 off the float64 clipped mean")
    check(bool(np.all(np.abs(card_norms - norm64) <= 1e-5 * norm64)), f"update norms {card_norms} against {norm64}")
    check(abs(alone_norm - clip) <= 1e-5 * clip, f"the clipped client was scaled to norm {alone_norm}, not {clip}")
    # (b) noise calibration over the whole model.
    mult = 1.0
    gen = torch.Generator(device="cuda").manual_seed(seed + 43)
    noised, _ = pdp.dp_fedavg(local, anchor, gen, None, clip=clip, noise_multiplier=mult)
    quiet, _ = pdp.dp_fedavg(local, anchor, None, None, clip=clip, noise_multiplier=0.0)
    diff = torch.cat([(noised[n].double() - quiet[n].double()).flatten() for n in noised])
    std, mean = float(diff.std()), float(diff.mean())
    sigma = mult * clip / FED_CLIENTS
    print(f"privacy: {card}: noise over {diff.numel()} coordinates: std {std:.6f} against noise * clip / n = {sigma} "
          f"({abs(std - sigma) / sigma:.2e} relative; bound 1e-2), mean {mean:.2e}", flush=True)
    check(abs(std - sigma) <= 0.01 * sigma and abs(mean) < 4 * sigma / np.sqrt(diff.numel()), f"noise std {std}, mean {mean}")
    del trainer, state, anchor, local, deltas, noised, quiet, diff
    torch.cuda.empty_cache()


def privacy_phase(seed: int, card: str, work: str) -> dict[str, int]:
    """DP-FedAvg, its accountant, accumulation and personalization through
    the ``federated`` verb at full width (the boundary checks first, see
    :func:`dp_boundary_check`): ``--dp-clip 1.0 --dp-noise-multiplier 1.1
    --participation 0.5`` (Poisson) ``--personalize-epochs 1
    --personalize-scope full`` with a ``--config`` whose
    ``train.grad_accum_steps`` is 2, over 2 rounds of 4 clients. Returns
    the launches of the verb and of one ``head`` personalization."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel.dp import (
        dp_epsilon_both,
    )

    dp_boundary_check(seed, card)
    args = build_parser().parse_args(["export-config", "--preset", "distilbert", "--attention-impl", "flash"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(args.fn(args) == 0, "export-config failed")
    d = json.loads(out.getvalue())
    d["train"]["grad_accum_steps"] = 2
    cfg_path = os.path.join(work, "priv_accum.json")
    with open(cfg_path, "w") as f:
        json.dump(d, f)
    out_dir = os.path.join(work, "priv_out")
    args = build_parser().parse_args(
        ["federated", "--config", cfg_path, *PRIV_ARGS, "--rounds", "2", "--epochs", "1", "--seed", str(seed),
         "--dp-clip", "1.0", "--dp-noise-multiplier", "1.1", "--participation", "0.5",
         "--personalize-epochs", "1", "--personalize-scope", "full", "--output-dir", out_dir]
    )
    with FedWatch() as watch:
        zero_with_fold()
        t0 = time.perf_counter()
        res = run_federated(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_with_fold()
    cfg, trainer, state = res["config"], res["trainer"], res["state"]
    mcfg, L, bs = cfg.model, cfg.model.n_layers, cfg.data.batch_size
    check((mcfg.dim, L, mcfg.attention_impl, mcfg.compute_dtype) == (768, 6, "flash", "bfloat16"), f"not full width: {mcfg}")
    check(cfg.fed.resolve_participation_mode() == "poisson" and cfg.train.grad_accum_steps == 2, f"config {cfg.fed}")
    n_rows = [int(n) for n in res["stacked_train"].n_rows]
    per_client = [-(-n // bs) for n in n_rows]  # micro steps an epoch
    fit_steps = 2 * sum(per_client)
    pers_steps = sum(per_client)
    val_cb = eval_client_batches(trainer.prepare_eval([c.val for c in res["clients"]]))
    test_cb = eval_client_batches(trainer.prepare_eval([c.test for c in res["clients"]]))
    eval_cb = 2 * 2 * (val_cb + test_cb) + 2 * test_cb  # local + aggregated each round, final and personalized
    q, _ = cfg.fed.dp_sampling_rate()
    eps = dp_epsilon_both(2, 1.1, 1e-5, sampling_rate=q)
    banner = res["dp_banner"] or ""
    print(f"privacy: {card}: federated (DP clip 1.0 noise 1.1, Poisson q {q}, grad_accum_steps 2, personalize full) "
          f"train rows {n_rows}, {fit_steps} micro client-steps + {pers_steps} personalizing, {eval_cb} eval "
          f"client-batches; wall {wall:.3f} s; launches {launches}", flush=True)
    print(f"privacy: banner: {banner}", flush=True)
    want_banner = (f"({eps[0]:.3g}, 1e-05)-DP under zeroed-contribution adjacency; "
                   f"({eps[1]:.3g}, 1e-05)-DP under replace-one adjacency")
    check(want_banner in banner and "Poisson sampling q=0.5 (accountant exact)" in banner, f"[DP] banner {banner!r}, want {want_banner!r}")
    for row in ("flash_fwd_dropout", "flash_bwd_dkdv", "flash_bwd_dq"):
        check(launches[row] == L * (fit_steps + pers_steps), f"{row} launched {launches[row]} for {fit_steps} + {pers_steps} client-steps")
    check(launches["flash_fwd"] == L * eval_cb, f"K1 (rate 0) launched {launches['flash_fwd']} for {eval_cb} eval client-batches")
    opt = state.opt_state
    want_count = [m // 2 for m in per_client]  # the last round's window (no reset after it)
    want_mini = [m % 2 for m in per_client]
    print(f"privacy: per client micro steps a round {per_client}: Adam counts {opt.count} (want {want_count}), "
          f"mini steps {opt.mini_step} (want {want_mini})", flush=True)
    check(opt.count == want_count and opt.mini_step == want_mini, "accumulation counts differ from the micro steps run")
    check(watch.gated is not None and watch.gated[2], f"an idle client's window moved: {watch.gated}")
    for h in res["history"]:
        check(np.isfinite(h.epoch_losses).all(), f"round {h.round + 1}: non-finite loss {h.epoch_losses}")
    for c in range(FED_CLIENTS):
        path = os.path.join(out_dir, f"client{c}_personalized_metrics.csv")
        check(path in res["metrics_csvs"] and os.path.exists(path), f"missing {path}")
        with open(path) as f:
            header, values = f.read().strip().splitlines()
        check(header == "Accuracy,Loss,Precision,Recall,F1-Score" and all(np.isfinite(float(v)) for v in values.split(",")),
              f"{path}: {values!r}")
    pers_loss = [m["Loss"] for m in res["personalized"]]
    agg_loss = [m["Loss"] for m in res["final"]]
    print(f"privacy: personalized test acc {[round(m['Accuracy'], 2) for m in res['personalized']]} and loss "
          f"{np.round(pers_loss, 6).tolist()} against aggregated {[round(m['Accuracy'], 2) for m in res['final']]} and "
          f"{np.round(agg_loss, 6).tolist()}", flush=True)
    check(pers_loss != agg_loss, "the personalized models score as the aggregate: personalization trained nothing")
    # Scope head on the aggregate: the encoder stays bit-equal; K2/K3 do not run.
    zero_with_fold()
    pstate, _ = trainer.personalize(state, res["stacked_train"], epochs=1, scope="head")
    head = read_with_fold()
    encoder = [n for n in state.params if not n.startswith("classifier.")]
    frozen = all(torch.equal(pstate.params[n], state.params[n]) for n in encoder)
    moved = not torch.equal(pstate.params["classifier.weight"], state.params["classifier.weight"])
    print(f"privacy: personalize scope head: {len(encoder)} encoder leaves bit-equal {frozen}, head moved {moved}; "
          f"launches {head}", flush=True)
    check(frozen and moved, "scope head changed the encoder or left the head")
    check(head["flash_fwd_dropout"] == L * pers_steps and head["flash_bwd_dkdv"] == head["flash_bwd_dq"] == 0, f"head launches {head}")
    add_launches(launches, head)
    del res, trainer, state, pstate
    torch.cuda.empty_cache()
    return launches


class _ScriptedCohort:
    """The server's cohort draws from a script (``random()``); its noise
    stays the OS-seeded Philox's (``standard_normal``)."""

    def __init__(self, draws, real):
        self._draws, self._real = list(draws), real

    def random(self):
        return self._draws.pop(0)

    def standard_normal(self, *a, **kw):
        return self._real.standard_normal(*a, **kw)


DP_CLIENT_ARGS = ["--preset", "distilbert", "--attention-impl", "flash", "--synthetic", "1200", "--epochs", "1",
                  "--timeout", "600", "--dp"]


def dp_invocation(seed: int, card: str, name: str, rounds: int, serve_flags: list[str], draws=None,
                  secret: str | None = None) -> tuple[list, dict]:
    """``serve --num-clients 2 --dp-clip 1.0`` with two ``client --dp`` over
    ``rounds`` rounds, through the parser, the fold on the card. Returns
    the server's per-round records (its return value, K4's launches) and
    the clients' ``run_client`` results."""
    old_secret = os.environ.pop("FEDTPU_SECRET", None)
    if secret is not None:
        os.environ["FEDTPU_SECRET"] = secret
    records, results, errors = [], {}, []
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            server = build_round_server(build_parser().parse_args(
                ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--timeout", "600",
                 "--dp-clip", "1.0", *serve_flags]
            ))
            check(server.device.type == "cuda" and server.dp_clip == 1.0, f"server folds on {server.device}")
            if draws is not None:
                server._dp_rng = _ScriptedCohort(draws, server._dp_rng)

            def serve() -> None:
                try:
                    for _ in range(rounds):
                        k4 = fold_mod.FOLD_LAUNCHES
                        agg = server.serve_round()
                        records.append({"agg": agg, "mean": server.last_mean, "k4": fold_mod.FOLD_LAUNCHES - k4,
                                        "fold": dict(server.last_fold_stats or {})})
                except BaseException as e:  # re-raised below, after the join
                    errors.append(e)

            def client(i: int) -> None:
                try:
                    results[i] = run_client(build_parser().parse_args(
                        ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port),
                         *DP_CLIENT_ARGS, "--rounds", str(rounds), "--seed", str(seed), "--output-dir", out_dir]
                    ))
                except BaseException as e:  # re-raised below, after the join
                    errors.append(e)

            with server:
                threads = [threading.Thread(target=serve)] + [threading.Thread(target=client, args=(i,)) for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
            check(not any(t.is_alive() for t in threads), f"dp-rounds ({name}) threads hung")
    finally:
        os.environ.pop("FEDTPU_SECRET", None)
        if old_secret is not None:
            os.environ["FEDTPU_SECRET"] = old_secret
    if errors:
        raise errors[0]
    check(len(records) == rounds and all(len(results[i]["rounds"]) == rounds for i in range(2)), f"dp-rounds ({name}) rounds")
    return records, results


def dp_rounds_phase(seed: int, card: str, work: str) -> dict[str, int]:
    """Central DP over TCP at full width, the fold on the card: (a) one
    round at noise 0, the reply delta bit-equal to numpy's fp32 fold of the
    two clipped uploads (K4 is bit-exact) and within 1e-6 of the terms'
    magnitude of the float64 mean; (b) three rounds at ``--dp-noise-multiplier 1.0
    --dp-participation 0.5`` with ``--dp-history-file`` and FEDTPU_SECRET
    set, the cohort draws scripted (both, only client 0, only client 1) so
    that each client sits a round out through ``DPSK``: both clients'
    bases bit-equal after every round, the history file holding the 3
    released deltas; (c) a stranded client (it drops round 1's reply)
    healed by the composed resync, bit-equal to the fleet, and round 3
    from the common base. Returns the launches (K4's under ``fold``)."""
    total = zero_launches()
    zero_with_fold()
    records, results = dp_invocation(seed, card, "noise 0", 1, ["--dp-noise-multiplier", "0"])
    add_launches(total, read_with_fold())
    uploads = [wire.flatten_params(results[i]["rounds"][0]["uploaded"]) for i in range(2)]
    bases = [wire.flatten_params(results[i]["rounds"][0]["round_base"]) for i in range(2)]
    check(all(np.array_equal(bases[0][k], bases[1][k]) for k in bases[0]), "the clients started from different bases")
    clipped, norms = [], []
    for u, b in zip(uploads, bases):
        c, norm, _ = wire.clip_flat({k: np.asarray(u[k], np.float32) - b[k] for k in b}, 1.0)
        clipped.append(c)
        norms.append(norm)
    agg = records[0]["agg"]
    bit_equal, worst = True, 0.0
    for k in clipped[0]:
        acc = np.zeros_like(clipped[0][k])
        for c in clipped:
            acc += np.float32(0.5) * c[k]
        bit_equal = bit_equal and np.array_equal(agg[k], acc)
        c0, c1 = (c[k].astype(np.float64) for c in clipped)
        scale = 0.5 * (np.abs(c0) + np.abs(c1))  # the terms' magnitude: cancellation leaves no relative bound
        ratio = np.abs(agg[k] - 0.5 * (c0 + c1)) / np.maximum(1e-6 * scale, np.finfo(np.float64).tiny)
        worst = max(worst, float(ratio.max(initial=0.0)))
    same = all(np.array_equal(wire.flatten_params(results[0]["aggregate"])[k], wire.flatten_params(results[1]["aggregate"])[k]) for k in bases[0])
    print(f"dp-rounds (a) {card}: upload delta norms {np.round(norms, 5).tolist()} (clip 1.0); reply delta bit-equal to "
          f"numpy's fp32 fold of the clipped deltas {bit_equal}, largest |reply - float64 mean| over 1e-6 x the terms' "
          f"magnitude {worst:.3e} (<= 1 passes); K4 {records[0]['k4']} launches; both clients' bases equal {same}", flush=True)
    check(bit_equal and worst <= 1.0 and same and records[0]["k4"] == 102, "dp-rounds (a)")

    hist = os.path.join(work, "dp_history.npz")
    zero_with_fold()
    records, results = dp_invocation(
        seed, card, "noise 1.0, q 0.5", 3,
        ["--dp-noise-multiplier", "1.0", "--dp-participation", "0.5", "--dp-history-file", hist],
        draws=[0.1, 0.1, 0.1, 0.9, 0.9, 0.1], secret="chip-smoke-dp-secret",
    )
    add_launches(total, read_with_fold())
    for r in range(3):
        a = [wire.flatten_params(results[i]["rounds"][r]["aggregate"]) for i in range(2)]
        same = all(np.array_equal(a[0][k], a[1][k]) for k in a[0])
        finite = all(np.isfinite(v).all() for v in a[0].values())
        x = [results[i]["rounds"][r]["exchange"] for i in range(2)]
        print(f"dp-rounds (b) {card}: round {r + 1}: uploads {[e['upload_shape'] for e in x]}, K4 {records[r]['k4']} "
              f"launches, reply {x[0]['meta'].get('dp_reply')} (round_clients {x[0]['meta'].get('round_clients')}); "
              f"bases bit-equal {same}, finite {finite}; waits {[round(e['reply_wait_s'], 3) for e in x]} s", flush=True)
        check(same and finite and records[r]["k4"] == 102, f"dp-rounds (b) round {r + 1}")
    sat_out = [[results[i]["rounds"][r]["exchange"]["upload_shape"] for i in range(2)] for r in range(3)]
    check(sat_out == [["dense", "dense"], ["dense", "none"], ["none", "dense"]], f"sit-outs {sat_out}")
    with np.load(hist, allow_pickle=False) as z:
        kept = len(json.loads(bytes(z["__index__"].tobytes()).decode()))
    print(f"dp-rounds (b): {hist} holds {kept} retained round deltas", flush=True)
    check(kept == 3, f"the history file holds {kept} deltas")

    zero_with_fold()
    stranded_check(seed, card)
    add_launches(total, read_with_fold())
    print(f"dp-rounds: launches {total}", flush=True)
    return total


def stranded_check(seed: int, card: str) -> None:
    """(c): full-width params (the seeded init, JAX layout) with seeded
    local deltas, through the library client."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import (
        AggregationServer,
        FederatedClient,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
        params_to_jax,
    )

    tok = default_tokenizer()
    cfg = ModelConfig.distilbert_base(vocab_size=len(tok.vocab))
    base0 = wire.flatten_params(params_to_jax(init_params(cfg, torch.Generator().manual_seed(seed + 47))))
    rng = np.random.default_rng(seed + 48)

    def step(b):
        return {k: v + rng.standard_normal(v.shape, dtype=np.float32) * np.float32(1e-4) for k, v in b.items()}

    def exchange_all(clients, params, bases):
        out, errors = {}, []

        def go(i):
            try:
                tree = clients[i].exchange(wire.unflatten_params(params[i]), round_base=wire.unflatten_params(bases[i]))
                out[i] = wire.flatten_params(tree)
            except BaseException as e:  # re-raised below
                errors.append(e)

        ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        return out

    with AggregationServer(host="127.0.0.1", port=0, num_clients=2, min_clients=1, timeout=600, dp_clip=1.0,
                           dp_noise_multiplier=1.0, device="cuda") as server:
        clients = [FederatedClient("127.0.0.1", server.port, client_id=i, timeout=600, dp=True) for i in range(2)]
        aggs = []

        def serve_one():
            aggs.append(server.serve_round())

        t = threading.Thread(target=serve_one)
        t.start()
        out = exchange_all(clients, [step(base0), step(base0)], [base0, base0])
        t.join(timeout=600)
        base1 = out[1]  # client 0 drops this reply: it stays at base0
        t = threading.Thread(target=serve_one)
        t.start()
        out = exchange_all(clients, [step(base0), step(base1)], [base0, base1])
        t.join(timeout=600)
        healed = all(np.array_equal(out[0][k], out[1][k]) for k in out[1])
        changed = not all(np.array_equal(out[1][k], base1[k]) for k in base1)
        base2 = out[1]
        t = threading.Thread(target=serve_one)
        t.start()
        out = exchange_all(clients, [step(base2), step(base2)], [base2, base2])
        t.join(timeout=600)
        agree = all(np.array_equal(out[0][k], out[1][k]) for k in out[1])
        third = server.last_fold_stats
    print(f"dp-rounds (c) {card}: the stranded client healed bit-equal to the fleet {healed} (round 2 moved the base "
          f"{changed}); round 3 from the common base: {len(aggs)} rounds released, bases equal {agree}, "
          f"{third['fold_engine']} fold", flush=True)
    check(healed and changed and agree and all(a is not None for a in aggs), "the stranded client did not heal")


def stream_phase(seed: int, card: str, work: str) -> dict[str, int]:
    """``--stream``: a 20,000-row CSV with NaN/inf cells read by the
    two-pass chunked reader. On a clean 20,000-row CSV its token arrays
    equal the in-memory loader's (disjoint and dirichlet partitions, as
    tests/test_streaming.py holds them); on the noisy one every label and
    shape matches and most rows' tokens do. Then ``local --stream``,
    ``federated --stream`` and ``distill --stream`` at full width for one
    epoch with finite losses. Returns their launches."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
        DataConfig,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.cicids import (
        make_all_client_splits,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.pipeline import (
        tokenize_client,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.data.streaming import (
        stream_client_tokens,
    )

    noisy, clean = os.path.join(work, "stream_noisy.csv"), os.path.join(work, "stream_clean.csv")
    write_flows_csv(noisy, 20000, seed + 51)
    write_flows_csv(clean, 20000, seed + 52, inf_fraction=0.0, nan_fraction=0.0)
    tok = default_tokenizer()
    for path, scheme, exact in ((clean, "disjoint", True), (clean, "dirichlet", True), (noisy, "disjoint", False)):
        dcfg = DataConfig(partition=scheme, data_fraction=0.05, max_len=128)
        t0 = time.perf_counter()
        got = stream_client_tokens(path, dcfg, 2, tok, chunk_rows=4096)
        t_stream = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [tokenize_client(s, tok, max_len=128) for s in make_all_client_splits(load_flow_csv(path), 2, dcfg)]
        t_mem = time.perf_counter() - t0
        equal_rows = total_rows = 0
        for a, b in zip(got, want):
            for split in ("train", "val", "test"):
                sa, sb = getattr(a, split), getattr(b, split)
                check(np.array_equal(sa.labels, sb.labels) and sa.input_ids.shape == sb.input_ids.shape,
                      f"stream {scheme}: {split} labels or shapes differ")
                same = (sa.input_ids == sb.input_ids).all(axis=1) & (sa.attention_mask == sb.attention_mask).all(axis=1)
                equal_rows += int(same.sum())
                total_rows += len(same)
        print(f"stream: {os.path.basename(path)} {scheme}: {total_rows} rows, {equal_rows} token rows equal to the "
              f"in-memory loader's; host seconds streamed {t_stream:.3f}, in memory {t_mem:.3f}", flush=True)
        check(equal_rows == total_rows if exact else equal_rows > 0.7 * total_rows, f"stream {scheme}: {equal_rows}/{total_rows}")
    flags = ["--preset", "distilbert", "--attention-impl", "flash", "--stream", "--csv", noisy, "--data-fraction", "0.02",
             "--epochs", "1", "--seed", str(seed)]
    total = zero_launches()
    zero_with_fold()
    res = run_local(build_parser().parse_args(["local", *flags, "--output-dir", os.path.join(work, "s_local")]))
    got = read_with_fold()
    add_launches(total, got)
    L, steps = res["config"].model.n_layers, res["state"].step
    print(f"stream: {card}: local --stream: {steps} steps, losses {res['losses']}; launches {got}", flush=True)
    check(steps > 0 and np.isfinite(res["losses"]).all() and got["flash_fwd_dropout"] == L * steps, "local --stream")
    zero_with_fold()
    res = run_federated(build_parser().parse_args(
        ["federated", *flags, "--num-clients", "2", "--partition", "disjoint", "--rounds", "1",
         "--output-dir", os.path.join(work, "s_fed")]
    ))
    got = read_with_fold()
    add_launches(total, got)
    losses = res["history"][0].epoch_losses
    print(f"stream: {card}: federated --stream: train rows {[int(n) for n in res['stacked_train'].n_rows]}, epoch losses "
          f"{np.round(losses, 4).tolist()}; launches {got}", flush=True)
    check(np.isfinite(losses).all() and got["flash_bwd_dq"] > 0, "federated --stream")
    zero_with_fold()
    res = run_distill(build_parser().parse_args(
        ["distill", *flags, "--teacher-layers", "6", "--student-layers", "3", "--output-dir", os.path.join(work, "s_distill")]
    ))
    got = read_with_fold()
    add_launches(total, got)
    print(f"stream: {card}: distill --stream: teacher losses {res['teacher_losses']}, KD losses {res['losses']}; "
          f"launches {got}", flush=True)
    check(np.isfinite(res["losses"]).all() and np.isfinite(res["teacher_losses"]).all(), "distill --stream")
    del res
    return total


def max_len_serve(card: str, work: str, cfg: ModelConfig, params: dict, texts: list[str]) -> dict[str, int]:
    """``infer-serve --hf-dir --max-len 64`` (the serving weights written
    as an HF directory) answering 32 flows at L=64, within bf16's bound
    (atol 1e-2) of the same weights scored at L=64 in fp32 on the CPU.
    Returns its launches."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.hf_convert import (
        write_hf_dir,
    )

    tok = default_tokenizer()
    hf = os.path.join(work, "serve_hf")
    write_hf_dir(hf, params, cfg, tok)
    server = build_server(build_parser().parse_args(
        serve_args("--preset", "distilbert", "--attention-impl", "flash", "--hf-dir", hf, "--max-len", "64")
    ))
    check(server.engine.device.type == "cuda" and server.engine.seq_len == 64, f"engine on {server.engine.device} at L={server.engine.seq_len}")
    texts = texts[:32]
    with server:
        zero_with_fold()
        b0 = server.stats()["batches"]
        replies = score_texts(server.port, texts)
        batches = server.stats()["batches"] - b0
        launches = read_with_fold()
    enc = tok.batch_encode(texts, max_len=64)
    cpu = ScoreEngine(dataclasses.replace(cfg, max_len=64, attention_impl="dot", compute_dtype="float32"),
                      {n: t.detach().cpu() for n, t in params.items()}, pad_id=tok.pad_id, buckets=(32,), device="cpu")
    want = cpu.score(enc["input_ids"], enc["attention_mask"])[0]
    got = np.array([r["prob"] for r in replies])
    diff = float(np.abs(got - want).max())
    print(f"serving: {card}: infer-serve --hf-dir --max-len 64: {len(replies)} replies in {batches} batches at L=64, "
          f"max|prob - fp32 CPU scorer at L=64| {diff:.3e} (bf16 atol 1e-2); launches {launches}", flush=True)
    check(diff <= 1e-2 and launches["flash_fwd"] == cfg.n_layers * batches, f"max-len 64 serving: diff {diff}, launches {launches}")
    return launches


# ------------------------------------------------- the robustness planes
ROBUST_CLIENT_ARGS = ["--preset", "distilbert", "--attention-impl", "flash", "--epochs", "1", "--timeout", "600"]
ROBUST_ROWS = 1200  # synthetic rows a client: the round cell's, 9 steps at bs16
SECURE_SECRET = "chip-smoke-secure-secret"
#: Seconds the secure round waits for the dead client's upload before it
#: unmasks over the survivors (from the moment all three start exchanging).
SECURE_DEADLINE = 45.0
#: The root's round-2 deadline: relay B is dead, so the root folds the one
#: surviving subtree when it passes.
TREE_R2_DEADLINE = 45.0


@contextlib.contextmanager
def exchange_gate(gate):
    """While it is open, every port ``FederatedClient.exchange`` first
    calls ``gate(client, n, kwargs)``, ``n`` counting that client's
    exchanges (the gate may edit the call's kwargs)."""
    orig = PortFederatedClient.exchange
    calls: dict[int, int] = collections.Counter()
    lock = threading.Lock()

    def exchange(self, *a, **kw):
        with lock:
            n = calls[id(self)]
            calls[id(self)] += 1
        gate(self, n, kw)
        return orig(self, *a, **kw)

    PortFederatedClient.exchange = exchange
    try:
        yield
    finally:
        PortFederatedClient.exchange = orig


def flash_steps_check(results: dict, launches: dict, what: str) -> None:
    """K1 with dropout, K2 and K3 launch once a layer a local step of every
    client; K1 at rate 0 once a layer an evaluation batch (the local
    evaluation, and the aggregate's of each client that got one)."""
    mcfg = next(iter(results.values()))["config"].model
    steps = sum(r["state"].step for r in results.values())
    # Two evaluation passes a completed round, one for a failed exchange.
    evals = sum(
        (2 * len(r["rounds"]) + (r["aggregated"] is None)) * -(-r["local"]["n"] // r["config"].data.eval_batch_size)
        for r in results.values()
    )
    want = mcfg.n_layers * steps
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == want,
          f"{what}: K1-dropout/K2/K3 launches {launches} for {steps} steps ({want} each)")
    check(launches["flash_fwd"] == mcfg.n_layers * evals, f"{what}: K1 (rate 0) launches {launches['flash_fwd']} for {evals} eval batches")


def robust_secure(seed: int, card: str, work: str) -> dict[str, int]:
    """(a) ``serve --num-clients 3 --min-clients 2 --secure-agg
    --secure-protocol double`` with three port ``client --secure-agg``;
    client 2 dials through a FaultProxy that resets it 4 KiB into its
    upload, after the share exchange, and does not come back. The round
    unmasks over the survivors."""
    os.environ["FEDTPU_SECRET"] = SECURE_SECRET
    try:
        server = build_round_server(build_parser().parse_args(
            ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "3", "--min-clients", "2",
             "--secure-agg", "--secure-protocol", "double", "--timeout", "600", "--device", "cuda"]
        ))
    finally:
        os.environ.pop("FEDTPU_SECRET")
    check(server.secure_agg and server.device.type == "cuda", f"secure {server.secure_agg}, fold on {server.device}")
    proxy = FaultProxy("127.0.0.1", server.port, plan=FaultSpec(reset_after_bytes=4096))
    results: dict[int, dict] = {}
    served: dict = {}
    errors: list[BaseException] = []
    start = threading.Barrier(4)

    def gate(fc, n, kw):
        start.wait(timeout=900)
        if fc.client_id == 2:
            kw["max_retries"] = 1  # a dead client does not come back

    def client(i: int) -> None:
        try:
            results[i] = run_client(build_parser().parse_args(
                ["client", "--client-id", str(i), "--host", "127.0.0.1",
                 "--port", str(proxy.port if i == 2 else server.port), "--num-clients", "3",
                 "--synthetic", str(3 * ROBUST_ROWS), "--secure-agg", "--min-participants", "2",
                 *ROBUST_CLIENT_ARGS, "--rounds", "1", "--seed", str(seed), "--output-dir", os.path.join(work, "secure")]
            ))
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)
            start.abort()  # the others must not wait for this client

    def serve() -> None:
        try:
            start.wait(timeout=900)
            t0 = time.perf_counter()
            served["agg"] = server.serve_round(deadline=SECURE_DEADLINE)
            served["wall"] = time.perf_counter() - t0
        except BaseException as e:
            errors.append(e)

    zero_with_fold()
    with server, proxy, exchange_gate(gate):
        os.environ["FEDTPU_SECRET"] = SECURE_SECRET
        try:
            threads = [threading.Thread(target=serve)] + [threading.Thread(target=client, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
        finally:
            os.environ.pop("FEDTPU_SECRET", None)
    launches = read_with_fold()
    check(not any(t.is_alive() for t in threads), "secure round threads hung")
    if errors:
        raise errors[0]
    check(bool(proxy.events_of("reset")), "client 2's connection was never reset")
    check(results[2]["aggregated"] is None and results[2]["aggregate"] is None, "the dead client got an aggregate")
    agg = served["agg"]
    ups = [{k: np.asarray(v) for k, v in wire.flatten_params(results[i]["uploaded"]).items()} for i in (0, 1)]
    ring = psecure.dequantize_sum(psecure.sum_masked([psecure.quantize(u) for u in ups]), 2)
    check(agg.keys() == ring.keys() and all(np.array_equal(agg[k], ring[k]) for k in ring),
          "the secure aggregate differs from dequantize_sum(sum of quantize(u)) over the survivors")
    plain = aggregate_flat(ups)
    err = max(float(np.abs(agg[k] - plain[k]).max()) for k in plain)
    check(err <= 2 * 2.0**-24, f"the secure aggregate is {err} off aggregate_flat (atol 2*2^-24)")
    for i in (0, 1):
        got = wire.flatten_params(results[i]["aggregate"])
        check(all(np.array_equal(got[k], agg[k]) for k in agg), f"client {i} received another aggregate")
        check(results[i]["state"].params[next(iter(results[i]["state"].params))].is_cuda,
              f"client {i} adopted the aggregate off the card")
    check(launches["fold"] == 0, f"K4 launched {launches['fold']} times in the secure round (its ring sum is numpy)")
    flash_steps_check(results, launches, "secure")
    n = sum(a.size for a in agg.values())
    mask_s = {i: results[i]["exchange"]["secure_s"] for i in (0, 1)}
    split = server.last_secure_s
    print(
        f"robust: {card}: secure round (double, 3 clients, client 2 dead after its shares): {len(agg)} leaves, "
        f"{n} parameters ({n * 8 / 1e6:.1f} MB of uint64 a masked upload); aggregate == dequantize_sum over the "
        f"survivors bit for bit, max|agg - aggregate_flat| {err:.3e} (atol {2 * 2.0**-24:.3e}); round wall "
        f"{served['wall']:.3f} s (deadline {SECURE_DEADLINE:.0f} s waited for the dead client); masking "
        + ", ".join(f"client {i} {s['mask']:.3f} s (keys {s['keys']:.3f} s, shares {s.get('shares', 0.0):.3f} s, "
                    f"unmask answer {s.get('unmask', 0.0):.3f} s)" for i, s in mask_s.items())
        + f"; server unmask round {split['unmask']:.3f} s, ring sum {split['ring_sum']:.3f} s, residues "
        f"{split['residues']:.3f} s; launches {launches}",
        flush=True,
    )
    return launches


def robust_tree(seed: int, card: str, work: str) -> dict[str, int]:
    """(b) a root ``serve --num-clients 2 --min-clients 1 --weighted``, two
    ``relay --num-clients 2`` and four port clients with ranked
    ``--parent`` lists, two rounds. Relay B's clients dial it through a
    DeadRelayFault whose seeded kill lands in round 2's uploads; they
    re-home to relay A and the root folds the surviving subtree."""
    root = build_round_server(build_parser().parse_args(
        ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--min-clients", "1", "--weighted",
         "--timeout", "600", "--device", "cuda"]
    ))
    relays = [
        build_relay(build_parser().parse_args(
            ["relay", "--host", "127.0.0.1", "--port", "0", "--parent-host", "127.0.0.1",
             "--parent-port", str(root.port), "--relay-id", str(r), "--num-clients", "2", "--rounds", "2",
             "--timeout", "600", "--device", "cuda"]
        ))
        for r in range(2)
    ]
    check(all(rel.server.device.type == "cuda" for rel in relays), "a relay folds off the card")
    # One dense fp32 upload of the model is ~4 bytes a parameter: the kill
    # lands past round 1's two uploads through the fault, inside round 2's.
    up_bytes = 4 * sum(p.numel() for p in model_skeleton(ModelConfig.distilbert_base()).state_dict().values())
    fault = DeadRelayFault(relays[1], seed=seed, kill_window=(int(2.3 * up_bytes), int(3.2 * up_bytes)), throttle_bps=0.0)
    parents = {
        i: [f"127.0.0.1:{relays[0].port}", f"127.0.0.1:{relays[1].port}"] if i < 2
        else [f"{fault.host}:{fault.port}", f"127.0.0.1:{relays[0].port}"]
        for i in range(4)
    }
    relay_parents = {id(rel.parent) for rel in relays}
    results: dict[int, dict] = {}
    errors: list[BaseException] = []
    rounds: list[dict] = []

    def gate(fc, n, kw):
        if id(fc) in relay_parents or fc.client_id >= 2 or n == 0:
            return
        # Relay A's own clients hold round 2 until the kill landed and the
        # re-homed uploads registered there, so relay A's round stays open
        # through the adoption.
        check(fault.killed.wait(timeout=600), "relay B was never killed")
        check(wait_registered(relays[0].server, [2, 3], timeout=600), "the re-homed uploads never reached relay A")

    def client(i: int) -> None:
        try:
            results[i] = run_client(build_parser().parse_args(
                ["client", "--client-id", str(i), "--num-clients", "4", "--synthetic", str(4 * ROBUST_ROWS),
                 *[a for p in parents[i] for a in ("--parent", p)], "--rehome-dial-budget", "5",
                 *ROBUST_CLIENT_ARGS, "--rounds", "2", "--seed", str(seed), "--output-dir", os.path.join(work, "tree")]
            ))
        except BaseException as e:
            errors.append(e)

    def serve_root() -> None:
        try:
            for r, deadline in enumerate((600.0, TREE_R2_DEADLINE)):
                t0 = time.perf_counter()
                agg = root.serve_round(deadline=deadline)
                torch.cuda.synchronize()
                rounds.append({
                    "agg": agg, "wall": time.perf_counter() - t0, "fold": fold_mod.FOLD_LAUNCHES,
                    "assignment": root.last_assignment,
                    "partials": [rel.server.last_mean for rel in relays] if r == 0 else None,
                    "phases": dict(root.phase_seconds),
                })
        except BaseException as e:
            errors.append(e)

    rehomes0 = registry_value("fedtpu_client_rehomes_total")
    zero_with_fold()
    with root, exchange_gate(gate):
        try:
            threads = [threading.Thread(target=serve_root)] + [
                threading.Thread(target=rel.serve, args=(2,)) for rel in relays
            ] + [threading.Thread(target=client, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
        finally:
            fault.close()
            for rel in relays:
                rel.close()
    launches = read_with_fold()
    check(not any(t.is_alive() for t in threads), "tree threads hung")
    if errors:
        raise errors[0]
    check(len(rounds) == 2 and all(r["agg"] is not None for r in rounds), f"root rounds {len(rounds)}")
    ups = {r: {i: {k: np.asarray(v) for k, v in wire.flatten_params(results[i]["rounds"][r]["uploaded"]).items()}
               for i in range(4)} for r in range(2)}
    ns = {r: [float(results[i]["rounds"][r]["n_samples"]) for i in range(4)] for r in range(2)}
    # Round 1: each relay's partial is the weighted barrier mean of its
    # subtree, the root's aggregate the tree's replay, K4 3 x 102.
    r1 = rounds[0]
    for g, part in zip(([0, 1], [2, 3]), r1["partials"]):
        want = aggregate_flat([ups[0][i] for i in g], [ns[0][i] for i in g])
        check(wire.flat_crc32(part) == wire.flat_crc32(want), f"relay {g}'s round-1 partial differs from aggregate_flat")
    check(r1["assignment"]["groups"] == [[0, 1], [2, 3]], f"round-1 assignment {r1['assignment']}")
    want1 = aggregate_tree([ups[0][i] for i in range(4)], ns[0], [[0, 1], [2, 3]])
    crc1 = wire.flat_crc32({k: np.asarray(v, np.float32) for k, v in r1["agg"].items()})
    check(crc1 == wire.flat_crc32(want1), "round 1's root aggregate differs from aggregate_tree")
    n_leaves = len(want1)
    check(r1["fold"] == 3 * n_leaves, f"K4 launched {r1['fold']} times in round 1 (want 3 x {n_leaves})")
    # Round 2: relay B killed, its clients re-homed to relay A, the root's
    # degraded round the replay over the recorded assignment.
    r2 = rounds[1]
    groups = r2["assignment"]["groups"]
    check(fault.killed.is_set() and groups == [[0, 1, 2, 3]], f"round-2 assignment {groups}")
    want2 = aggregate_tree([ups[1][i] for i in range(4)], ns[1], groups)
    crc2 = wire.flat_crc32({k: np.asarray(v, np.float32) for k, v in r2["agg"].items()})
    check(crc2 == wire.flat_crc32(want2), "round 2's root aggregate differs from aggregate_tree over the assignment")
    for i in range(4):
        got = wire.flatten_params(results[i]["aggregate"])
        check(wire.flat_crc32(got) == crc2, f"client {i} received another round-2 aggregate")
    rehomed = {i: results[i]["client"].rehomes for i in range(4)}
    drift = registry_value("fedtpu_client_rehomes_total") - rehomes0
    check(all(rehomed[i] for i in (2, 3)) and not any(rehomed[i] for i in (0, 1)), f"re-homes {rehomed}")
    check(drift == 2, f"fedtpu_client_rehomes_total rose by {drift}, want 2")
    check(root.tree_totals["subtree_failures"] == 1, f"root tree totals {root.tree_totals}")
    flash_steps_check(results, launches, "tree")
    hops = {i: results[i]["rounds"][1]["exchange"] for i in range(4)}
    print(
        f"robust: {card}: relay tree (2 relays x 2 clients, weighted root): round 1 root crc {crc1:#010x} == "
        f"aggregate_tree, relay partials == aggregate_flat, K4 {r1['fold']} (3 x {n_leaves}), root round "
        f"{r1['wall']:.3f} s; round 2 relay B killed after {fault.kill_after_bytes} forwarded bytes, re-homes "
        f"{rehomed}, assignment {groups}, root crc {crc2:#010x} == aggregate_tree, K4 {launches['fold'] - r1['fold']} "
        f"(relay A over 4 uploads, the root, and relay B's folds before its kill), root round {r2['wall']:.3f} s "
        f"(deadline {TREE_R2_DEADLINE:.0f} s waited for relay B); per-hop round 2: "
        + ", ".join(f"client {i} upload {h['upload_s']:.3f} s ({h['upload_bytes'] / 1e6:.1f} MB {h['upload_shape']}), "
                    f"reply wait {h['reply_wait_s']:.3f} s" for i, h in hops.items())
        + f"; launches {launches}",
        flush=True,
    )
    return launches


def robust_scenario(card: str, work: str) -> dict[str, int]:
    """(c) ``scenario`` on the card through the port's CLI: the default
    matrix (lazy, slow, intermittent x iid, dirichlet, the auth cell, the
    dead-relay cell), then one ``--train`` cell (``ModelConfig.tiny()``,
    dot attention, as in the JAX package)."""
    out: dict[str, list] = {}
    zero_with_fold()
    for name, extra in (
        ("matrix", []),
        ("train", ["--train", "--personas", "lazy", "--partitions", "iid", "--no-auth-cell", "--no-dead-relay-cell"]),
    ):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["scenario", "--json", "--out-dir", os.path.join(work, f"scenario-{name}"), "--device", "cuda", *extra])
        check(rc == 0, f"scenario {name} exited {rc} (contract violations)")
        records = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        for rec in records:
            for r in rec["rounds"]:
                check(r["ok"] and r["bitexact"] is True, f"scenario {rec['cell']} round {r['round']}: {r}")
        out[name] = records
        print(
            f"robust: {card}: scenario {name}: {len(records)} cells, "
            + ", ".join(f"{r['cell']} {sum(x['ok'] for x in r['rounds'])}/{len(r['rounds'])} ok crc-exact"
                        + (f" acc {r['accuracy']}" if r["accuracy"] is not None else "") for r in records)
            + f"; {time.perf_counter() - t0:.1f} s",
            flush=True,
        )
    cells = [r["cell"] for r in out["matrix"]]
    check(len(cells) == 8 and cells[-2:] == ["lazy|iid|auth", "dead-relay|iid"], f"matrix cells {cells}")
    launches = read_with_fold()
    check(launches["fold"] > 0, "no scenario server folded on the card")
    print(f"robust: scenario K4 launches {launches['fold']}", flush=True)
    return launches


def robust_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 13: the robustness planes on the card: (a) a secure round
    with a dropout, (b) a relay tree with a relay killed, (c) the
    ``scenario`` matrix. Returns each kernel's launches during it."""
    t_phase = time.perf_counter()
    total = zero_launches()
    with tempfile.TemporaryDirectory() as work:
        for part in (robust_secure, robust_tree):
            add_launches(total, part(seed, card, work))
        add_launches(total, robust_scenario(card, work))
    print(f"robust: launches {total}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------- slice 15
GATE_SECRET = "chip-smoke-gates-secret"
GATE_FLOWS = 256
GATE_SWEEP_FLOWS = 1024  # closed-loop load the rolling reload runs under
GATE_MIN_PAIRS = 64  # a multiple of the comparator's status stride (8)
GATE_BINS = 10  # ShadowConfig.bins
GATE_CLIENT_ARGS = [*CONTROL_CLIENT_ARGS[:8], "--rounds", "1", "--timeout", "600"]
GATE_SHADOW_FLAGS = ["--shadow-gate", "--shadow-min-pairs", str(GATE_MIN_PAIRS), "--shadow-timeout", "600",
                     # The shadow rung passes on any evidence here, so the
                     # label rung behind it rules too; (b) forces it both ways.
                     "--shadow-max-flip-rate", "1.0", "--shadow-psi-threshold", "1e9"]
GATE_LABEL_FLAGS = ["--label-gate", "--label-min-joined", "32", "--label-coverage-floor", "0.05", "--error-drift"]


def head_variant(params: dict, *, bias=(0.0, 0.0), sign: float = 1.0) -> dict:
    """``params`` with the classifier's logits times ``sign`` plus ``bias``:
    a distinct artifact whose scores are known from the original's."""
    out = dict(params)
    out["classifier.weight"] = params["classifier.weight"] * sign
    out["classifier.bias"] = params["classifier.bias"] * sign + torch.tensor(bias, dtype=torch.float32)
    return out


def pair_records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def pairs_status(recs: list[dict]) -> dict:
    """The comparator's evidence recomputed from its pairs JSONL alone:
    counts, flip rate, the fixed [0, 1] bins and their PSI."""
    s = np.array([r["serving_prob"] for r in recs], np.float64)
    c = np.array([r["shadow_prob"] for r in recs], np.float64)
    flips = int(((s >= 0.5) != (c >= 0.5)).sum())
    hist = [np.bincount(np.minimum((np.clip(x, 0.0, 1.0) * GATE_BINS).astype(int), GATE_BINS - 1),
                        minlength=GATE_BINS) for x in (s, c)]
    check(flips == sum(r["flip"] for r in recs), "a pair record's flip disagrees with its probabilities")
    return {"pairs": len(recs), "flips": flips, "flip_rate": flips / len(recs) if recs else 0.0,
            "psi": round(drift_psi(hist[0], hist[1]), 6)}


def journal_labels(path: str) -> dict[str, int]:
    """rid -> label from a ground-truth journal, last writer (by ts) wins."""
    best: dict[str, tuple[float, int]] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "rid" in rec and rec["ts"] >= best.get(rec["rid"], (-np.inf, 0))[0]:
                best[rec["rid"]] = (rec["ts"], rec["label"])
    return {rid: label for rid, (_, label) in best.items()}


def supervised_report(recs: list[dict], labels: dict[str, int]) -> dict:
    """The label join recomputed: each side's error over the pairs whose
    request id has a label, and the coverage of all pairs."""
    hits = [(r, labels[r["rid"]]) for r in recs if r.get("rid") in labels]
    models = {}
    for side, key in (("serving", "serving_prob"), ("candidate", "shadow_prob")):
        wrong = sum(int(r[key] >= 0.5) != int(y != 0) for r, y in hits)
        models[side] = {"error": wrong / len(hits) if hits else None}
    return {"joined": len(hits), "total": len(recs), "coverage": len(hits) / len(recs) if recs else 0.0,
            "models": models}


def wait_pairs(path: str, n: int, errors: list | None = None) -> list[dict]:
    wait_for(lambda: (os.path.exists(path) and len(pair_records(path)) >= n) or bool(errors), 120, f"{n} mirrored pairs")
    recs = pair_records(path)
    check(len(recs) == n, f"{len(recs)} mirrored pairs, want {n}")
    return recs


def gates_fleet(seed: int, card: str, ctx: dict) -> None:
    """(a) Two replicas behind the router, following the registry: replies
    against a lone engine, both replicas answering, a promotion rolled
    across them under load, and the ``route`` verb in front of them."""
    fleet, key, reg, texts, refs = ctx["fleet"], ctx["key"], ctx["reg"], ctx["texts"], ctx["refs"]
    replies = score_texts(fleet.port, texts, auth_key=key)
    diff = float(np.abs(np.array([r["prob"] for r in replies]) - refs[1]).max())
    print(f"gates (a): {len(replies)} replies through the router, max|prob - lone engine| {diff:.3e} (bf16 atol 1e-2)",
          flush=True)
    check(diff <= 1e-2 and {r["round"] for r in replies} == {1}, f"router replies: diff {diff}, "
          f"rounds {sorted({r['round'] for r in replies})}")
    res = run_load("127.0.0.1", fleet.port, texts, concurrency=8, requests=GATE_FLOWS, timeout=120, auth_key=key)
    ctx["p99"] = {"no mirror": res["p99_ms"]}
    load_line(card, "gates (a): closed loop through the router, 8 connections", res)
    check(res["scored"] == GATE_FLOWS and res["rejected"] == 0, f"load: {res['scored']} scored, {res['rejected']} rejected")
    per_rep = [fetch_stats("127.0.0.1", r.port, auth_key=key) for r in fleet.replicas]
    s = fleet.stats()
    print(f"gates (a): replicas scored {[p['scored'] for p in per_rep]}, stats ids {[p['replica'] for p in per_rep]}; "
          f"router backends {[(b['replica'], b['healthy'], b['round']) for b in s['backends']]}", flush=True)
    check([p["replica"] for p in per_rep] == [0, 1] and all(p["scored"] > 0 for p in per_rep),
          f"replica stats {[(p['replica'], p['scored']) for p in per_rep]}")
    check([b["replica"] for b in s["backends"]] == [0, 1] and s["healthy"] == 2, f"router stats {s}")

    # The rolling reload under load: a sampler through the router records
    # (round, prob) of one flow all along, next to a closed-loop load.
    samples: list[tuple[int, float]] = []
    stop, errors, out = threading.Event(), [], {}

    def sampler() -> None:
        try:
            with ScoringClient("127.0.0.1", fleet.port, timeout=120, auth_key=key) as c:
                while not stop.is_set():
                    r = c.score(text=texts[0])
                    samples.append((r["round"], r["prob"]))
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    def loader() -> None:
        try:
            out.update(run_load("127.0.0.1", fleet.port, texts, concurrency=8, requests=GATE_SWEEP_FLOWS,
                                timeout=300, auth_key=key))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=sampler), threading.Thread(target=loader)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        a2 = publish(reg, ctx["params2"], 2, ctx["cfg"])
        wait_for(lambda: fleet.stats()["reloads"] >= 1 or errors, 120, "the rolling reload")
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "sampler or load threads hung")
    if errors:
        raise errors[0]
    rounds = sorted({r for r, _ in samples})
    worst = max(abs(p - refs[r][0]) for r, p in samples)
    print(f"gates (a): rolling reload to {a2} under {out['scored']} closed-loop requests: rejected {out['rejected']}; "
          f"sampler {len(samples)} replies over rounds {rounds}, max|prob - its round's lone engine| {worst:.3e}", flush=True)
    check(out["scored"] == GATE_SWEEP_FLOWS and out["rejected"] == 0, f"sweep load {out['scored']} / {out['rejected']}")
    check(rounds == [1, 2] and worst <= 1e-2, "a reply during the sweep does not carry its weights' round")
    check([r.round_id for r in fleet.replicas] == [2, 2], f"replica rounds {[r.round_id for r in fleet.replicas]}")
    with open(os.path.join(reg, "events.jsonl")) as f:
        reloads = [e for e in map(json.loads, f) if e["event"] == "reload"]
    check(sorted((e["artifact"], e["consumer"]) for e in reloads) == [(a2, "replica-0"), (a2, "replica-1")],
          f"registry reload events {reloads}")
    drains = [s for s in obs_mod.load_spans([ctx["spans"]]) if s["span"] == "replica-drain"]
    print(f"gates (a): {card}: replica-drain per replica " + ", ".join(
        f"r{s['replica']} {s['dur_s'] * 1e3:.1f} ms (drained {s['drained']})" for s in drains), flush=True)
    check(sorted((s["replica"], s["round"], s["artifact"]) for s in drains) == [(0, 2, a2), (1, 2, a2)],
          f"replica-drain spans {drains}")
    after = score_texts(fleet.port, texts[:64], auth_key=key)
    diff2 = float(np.abs(np.array([r["prob"] for r in after]) - refs[2][:64]).max())
    check({r["round"] for r in after} == {2} and diff2 <= 1e-2, f"after the sweep: rounds "
          f"{sorted({r['round'] for r in after})}, diff {diff2}")

    # The route verb through the port's CLI, keyed, in front of the same replicas.
    route = build_router(build_parser().parse_args([
        "route", *(a for r in fleet.replicas for a in ("--backend", f"127.0.0.1:{r.port}")), "--auth",
        "--host", "127.0.0.1", "--port", "0", "--probe-interval", "0.2",
    ]))
    with route.router as router:
        with ScoringClient("127.0.0.1", router.port, timeout=120, auth_key=key) as c:
            via = [c.score(text=t) for t in texts[:8]]
        with ScoringClient("127.0.0.1", fleet.replicas[0].port, timeout=120, auth_key=key) as c:
            direct = [c.score(text=t) for t in texts[:8]]
        try:
            with ScoringClient("127.0.0.1", router.port, timeout=30) as c:
                c.score(text=texts[0])
            refused = False
        except WireError:
            refused = True
    print(f"gates (a): route --auth: 8 replies equal to the replica's own {[a['prob'] for a in via] == [d['prob'] for d in direct]}"
          f"; a keyless client refused {refused}", flush=True)
    check([(a["prob"], a["round"]) for a in via] == [(d["prob"], d["round"]) for d in direct], "route replies differ")
    check(refused, "the keyed router answered a keyless client")


def shadow_verdict(ctx: dict, params: dict, round_id: int) -> tuple[str, bool, dict, list[dict]]:
    """Add ``params`` and enter them into the shadow state, mirror exactly
    GATE_MIN_PAIRS pairs (stride 2) and rule with the shadow gate; the
    verdict must equal ``evaluate_status`` of the pairs JSONL recomputed.
    Returns the artifact, the verdict and the pairs."""
    fleet, reg, key = ctx["fleet"], ctx["reg"], ctx["key"]
    registry = ModelRegistry(reg)
    aid = registry.add(params, round_index=round_id, model_config=ctx["cfg"])
    registry.promote(aid, to="shadow")
    t0 = time.perf_counter()
    wait_for(lambda: fleet.stats()["shadow_artifact"] == aid, 120, f"the shadow plane armed for {aid}")
    armed_s = time.perf_counter() - t0
    shadow = fleet._shadow_replica
    check(shadow.engine.device.type == "cuda" and shadow.round_id == round_id, "the shadow replica")
    res = run_load("127.0.0.1", fleet.port, ctx["texts"], concurrency=8, requests=2 * GATE_MIN_PAIRS, timeout=120,
                   auth_key=key)
    check(res["rejected"] == 0, "a live request was rejected while mirroring")
    recs = wait_pairs(shadow_pairs_path(reg, aid), GATE_MIN_PAIRS)
    ok, verdict = ShadowGate(reg, min_pairs=GATE_MIN_PAIRS, timeout_s=60.0, poll_s=0.1).wait(aid)
    status = pairs_status(recs)
    want = evaluate_status(status, min_pairs=GATE_MIN_PAIRS, max_flip_rate=0.02, psi_threshold=0.25)
    mstats = fleet.stats()["shadow_mirror"]
    print(f"gates (b): {aid} armed in {armed_s:.2f} s, mirror {mstats}; gate {'PASS' if ok else 'FAIL'}: "
          f"{verdict['reason']}; recomputed from the pairs file {status}", flush=True)
    check((ok, verdict["reason"]) == want, f"gate {(ok, verdict['reason'])} vs recomputed {want}")
    check(verdict["pairs"] == status["pairs"] and verdict["flip_rate"] == status["flip_rate"]
          and verdict["psi"] == status["psi"], f"gate evidence {verdict} vs {status}")
    return aid, ok, verdict, recs


def gates_shadow(seed: int, card: str, ctx: dict) -> None:
    """(b) The shadow gate forced both ways: an agreeing candidate
    promotes and the fleet rolls onto it; a negated head is rejected with
    the verdict on the registry event and the pointer held."""
    fleet, reg, key = ctx["fleet"], ctx["reg"], ctx["key"]
    registry = ModelRegistry(reg)
    pa = head_variant(ctx["params2"], bias=(0.0, 1e-6))
    aa, ok, verdict, recs = shadow_verdict(ctx, pa, 3)
    worst = max(abs(r["serving_prob"] - r["shadow_prob"]) for r in recs)
    check(ok and verdict["flip_rate"] == 0.0 and worst <= 1e-2, f"the agreeing candidate: {verdict}, max|dprob| {worst}")
    # The mirror armed: the live p99 of the same closed loop as (a)'s.
    res = run_load("127.0.0.1", fleet.port, ctx["texts"], concurrency=8, requests=GATE_FLOWS, timeout=120, auth_key=key)
    ctx["p99"]["mirror 1/2"] = res["p99_ms"]
    load_line(card, "gates (b): the same closed loop with the mirror armed (1/2)", res)
    check(res["rejected"] == 0, "rejects with the mirror armed")
    registry.promote(aa, to="serving")
    wait_for(lambda: fleet.stats()["reloads"] >= 2 and fleet.stats()["shadow_artifact"] is None, 120,
             "the fleet rolling onto the agreeing candidate")
    check([r.round_id for r in fleet.replicas] == [3, 3], f"replica rounds {[r.round_id for r in fleet.replicas]}")

    ab, ok, verdict, recs = shadow_verdict(ctx, head_variant(pa, sign=-1.0), 4)
    worst = max(abs(r["shadow_prob"] - (1.0 - r["serving_prob"])) for r in recs)
    check(not ok and verdict["flip_rate"] >= 0.99 and worst <= 2e-2,
          f"the negated head: {verdict}, max|p_shadow - (1 - p_serving)| {worst}")
    registry.reject(ab, reason=verdict["reason"], verdict=verdict)
    with open(os.path.join(reg, "events.jsonl")) as f:
        rej = [e for e in map(json.loads, f) if e["event"] == "rejected" and e["artifact"] == ab]
    check(len(rej) == 1 and rej[0]["verdict"] == verdict, f"the rejected event {rej}")
    check(registry.serving_info()["artifact"] == aa and registry.shadow_info() is None, "pointers after the rejection")
    wait_for(lambda: fleet.stats()["shadow_artifact"] is None, 60, "the shadow plane torn down")


def gates_controller(seed: int, card: str, ctx: dict, work: str) -> dict[str, int]:
    """(c) The controller with --shadow-gate --label-gate --error-drift over
    the fleet: one round of the control cell, its candidate mirrored by
    live labelled flows whose truth lands in the journal between two
    bursts. Returns each kernel's launches during the round."""
    fleet, reg, key = ctx["fleet"], ctx["reg"], ctx["key"]
    run = build_controller(build_parser().parse_args([
        "controller", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--rounds", "1",
        "--registry-dir", reg, "--gate-min-delta", "100", "--round-deadline", "600", "--timeout", "600",
        "--seed", str(seed), *GATE_SHADOW_FLAGS, *GATE_LABEL_FLAGS, *CONTROL_CLIENT_ARGS[:6], "--device", "cuda",
    ]))
    ctl = run.controller
    check(dataclasses.asdict(run.cfg.model) == dataclasses.asdict(ctx["cfg"]), "the controller's model config")
    check(ctl.shadow_gate is not None and ctl.label_gate is not None and ctl.error_monitor is not None, "gates unarmed")
    registry = ModelRegistry(reg)
    incumbent = registry.serving_info()["artifact"]
    results: dict[int, dict] = {}
    errors: list[BaseException] = []

    def controller() -> None:
        try:
            with run.server:
                ctl.run(max_rounds=1)
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    def client(i: int) -> None:
        try:
            results[i] = run_client(build_parser().parse_args(
                ["client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(run.server.port),
                 *GATE_CLIENT_ARGS, "--seed", str(seed), "--output-dir", os.path.join(work, "gate-clients")]
            ))
        except BaseException as e:
            errors.append(e)

    flows = make_synthetic_flows(2 * GATE_MIN_PAIRS, seed=seed + 83, inf_fraction=0.0, nan_fraction=0.0)
    texts = frame_texts(flows)
    truth = (np.asarray(flows["Label"]) != "BENIGN").astype(int)
    first = 2 * (GATE_MIN_PAIRS - 8)  # 56 pairs: one status stride short of the gate
    zero_with_fold()
    threads = [threading.Thread(target=controller)] + [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    try:
        def armed() -> bool:
            aid = (registry.shadow_info() or {}).get("artifact")
            return aid not in (None, incumbent) and fleet.stats()["shadow_artifact"] == aid

        wait_for(lambda: errors or armed(), 900, "the round's candidate armed in the shadow plane")
        if errors:
            raise errors[0]
        cand = registry.shadow_info()["artifact"]
        store = LabelStore(label_journal_path(reg))
        with PipelinedScoringClient("127.0.0.1", fleet.port, timeout=120, auth_key=key) as c:
            replies = [f.result(timeout=120) for f in [c.submit(text=t) for t in texts[:first]]]
            wait_pairs(shadow_pairs_path(reg, cand), first // 2, errors)
            # The delayed truth of the first burst lands before the last
            # pairs that let the shadow gate rule.
            for i, (r, y) in enumerate(zip(replies, truth)):
                store.ingest(str(r["id"]), int(y), ts=float(i))
            store.advance_watermark(float(first))
            replies += [f.result(timeout=120) for f in [c.submit(text=t) for t in texts[first:]]]
        check(all(r["round"] == 3 for r in replies), "the live replies came from another model than the incumbent")
        for t in threads:
            t.join(timeout=900)
    finally:
        for t in threads:
            t.join(timeout=1)
    check(not any(t.is_alive() for t in threads), "controller or client threads hung")
    if errors:
        raise errors[0]
    launches = read_with_fold()
    obs_mod.set_global_tracer(None)
    with open(os.path.join(reg, "controller_state.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    recs = pair_records(shadow_pairs_path(reg, cand))
    status = pairs_status(recs)
    want_shadow = evaluate_status(status, min_pairs=GATE_MIN_PAIRS, max_flip_rate=1.0, psi_threshold=1e9)
    print(f"gates (c): round 0 -> {rec['event']} ({cand}); shadow verdict {rec['shadow_verdict']}; recomputed "
          f"{status}", flush=True)
    check(rec["artifact"] == cand and rec["shadow_verdict"]["reason"] == want_shadow[1]
          and rec["shadow_verdict"]["pairs"] == status["pairs"] == GATE_MIN_PAIRS
          and rec["shadow_verdict"]["flip_rate"] == status["flip_rate"] and rec["shadow_verdict"]["psi"] == status["psi"],
          f"the controller's shadow verdict {rec['shadow_verdict']} vs recomputed {status} {want_shadow}")
    report = supervised_report(recs, journal_labels(label_journal_path(reg)))
    want_label = evaluate_supervised(report, min_joined=32, coverage_floor=0.05, max_regression=0.0)
    got = rec["label_verdict"]
    print(f"gates (c): label verdict {got}; recomputed {report} -> {want_label}", flush=True)
    check(got["reason"] == want_label[1] and got["joined"] == report["joined"] == first // 2
          and got["coverage"] == round(report["coverage"], 6)
          and got["serving_error"] == report["models"]["serving"]["error"]
          and got["candidate_error"] == report["models"]["candidate"]["error"],
          f"the controller's label verdict {got} vs recomputed {report} {want_label}")
    check(rec["event"] == ("promoted" if want_label[0] else "label_rejected"), f"record {rec['event']} vs {want_label}")
    with open(os.path.join(reg, "events.jsonl")) as f:
        events = [e for e in map(json.loads, f) if e.get("artifact") == cand]
    if rec["event"] == "promoted":
        check(registry.serving_info()["artifact"] == cand and events[-1]["event"] == "serving", f"registry {events[-1]}")
        check(ctl.error_monitor.has_reference, "promotion did not anchor the error-rate reference")
        wait_for(lambda: fleet.stats()["reloads"] >= 3, 120, "the fleet rolling onto the promoted candidate")
    else:
        verdict = events[-1].get("verdict") or {}
        check(events[-1]["event"] == "rejected" and events[-1]["reason"] == got["reason"]
              and all(verdict.get(k) == v for k, v in got.items()), f"registry {events[-1]} vs record {got}")
        check(registry.serving_info()["artifact"] == incumbent, "the pointer moved on a rejection")
    check(registry.shadow_info() is None, f"shadow pointer {registry.shadow_info()}")
    wait_for(lambda: fleet.stats()["shadow_artifact"] is None, 60, "the shadow plane torn down")
    steps = sum(results[i]["state"].step for i in range(2))
    n_layers = ctx["cfg"].n_layers
    check(launches["fold"] == 102, f"K4 launched {launches['fold']} times in one round, want 102")
    check(launches["flash_fwd_dropout"] == launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == n_layers * steps,
          f"K1-dropout/K2/K3 launches {launches} for {steps} client steps")
    return launches


def gates_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 14: the gate stack on the card, through the port's parser:
    (a) ``fleet`` and ``route``, (b) the shadow gate forced both ways,
    (c) the controller gated on live evidence. Returns each kernel's
    launches during it."""
    t_phase = time.perf_counter()
    tok = default_tokenizer()
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        resolve_config,
    )

    cfg = resolve_config(build_parser().parse_args(["controller", "--registry-dir", "-", *CONTROL_CLIENT_ARGS[:4]]),
                         vocab_size=len(tok.vocab)).model
    check((cfg.dim, cfg.n_layers, cfg.attention_impl, cfg.compute_dtype) == (768, 6, "flash", "bfloat16"),
          f"not full width: {cfg}")
    params = head_variant(init_params(cfg, torch.Generator().manual_seed(seed + 71)), bias=(-1.0, 1.0))
    params2 = head_variant(init_params(cfg, torch.Generator().manual_seed(seed + 72)), bias=(1.0, -1.0))
    texts = [flow_to_text(r) for r in flow_records(seed + 81, GATE_FLOWS)]
    enc = tok.batch_encode(texts, max_len=cfg.max_len)
    refs = {}
    for r, p in ((1, params), (2, params2)):  # a lone engine's answers: the check's, before the counts
        lone = ScoreEngine(cfg, p, pad_id=tok.pad_id, buckets=(1, 8, 32))
        refs[r] = np.concatenate([lone.score(enc["input_ids"][i:i + 32], enc["attention_mask"][i:i + 32])[0]
                                  for i in range(0, GATE_FLOWS, 32)])
        del lone
    check(float(np.abs(refs[1] - refs[2]).min()) > 0.1, "the two artifacts' scores are not told apart")
    total = zero_launches()
    with tempfile.TemporaryDirectory() as work:
        reg = os.path.join(work, "registry")
        spans = os.path.join(work, "fleet-spans.jsonl")
        publish(reg, params, 1, cfg)
        # One secret keys the whole phase: the fleet's front and replicas,
        # the route verb, the shadow mirror and the controller's round.
        os.environ["FEDTPU_SECRET"] = GATE_SECRET
        zero_with_fold()
        try:
            fleet = build_fleet(build_parser().parse_args([
                "fleet", "--registry-dir", reg, "--replicas", "2", "--buckets", "1,8,32", "--auth",
                "--host", "127.0.0.1", "--port", "0", "--reload-poll", "0.2", "--max-wait-ms", "5",
                "--shadow-sample", "2", "--trace-jsonl", spans, "--device", "cuda",
            ])).fleet
            check(all(r.engine.device.type == "cuda" and dataclasses.asdict(r.engine.model_cfg) == dataclasses.asdict(cfg)
                      for r in fleet.replicas), "replicas not on the card at full width")
            ctx = {"fleet": fleet, "key": GATE_SECRET.encode(), "reg": reg, "texts": texts, "refs": refs, "cfg": cfg,
                   "params2": params2, "spans": spans}
            with fleet:
                t0 = time.perf_counter()
                gates_fleet(seed, card, ctx)
                t1 = time.perf_counter()
                gates_shadow(seed, card, ctx)
                add_launches(total, read_with_fold())
                t2 = time.perf_counter()
                add_launches(total, gates_controller(seed, card, ctx, work))
        finally:
            del os.environ["FEDTPU_SECRET"]
            obs_mod.set_global_tracer(None)
    print(f"gates: {card}: live p99 {ctx['p99']} ms (mirror's added p99 "
          f"{ctx['p99']['mirror 1/2'] - ctx['p99']['no mirror']:+.2f} ms); (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
          f"(c) {time.perf_counter() - t2:.1f} s; launches {total}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(total["flash_fwd"] > 0 and total["flash_fwd"] % cfg.n_layers == 0, f"K1 rate-0 launches {total['flash_fwd']}")
    return total


# The mesh phase: two slots of a host mesh on the one card (slots may
# share a device; every placement onto a slot copies).
MESH_STEPS = 9
MESH_WORKER = r"""
import json, sys
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import main
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import flash_attention as f
rc = main(sys.argv[1:])
print("LAUNCHES " + json.dumps({"flash_fwd": f.FWD_LAUNCHES, "flash_fwd_dropout": f.FWD_DROPOUT_LAUNCHES,
      "flash_bwd_dkdv": f.DKDV_LAUNCHES, "flash_bwd_dq": f.DQ_LAUNCHES}), flush=True)
sys.exit(rc)
"""
# The JAX package's refusals of a mesh the card cannot hold (its CLI and
# MeshConfig messages, which the port's copy keeps word for word).
JAX_FSDP_ONE = "mesh.fsdp needs data >= 2 (--data-parallel N): sharding the static state over one device is a no-op"
JAX_SERVE_FSDP_ONE = "--fsdp shards the model over the serving mesh: pass --data-parallel N with N >= 2"


def two_slots() -> list:
    return [torch.device("cuda", 0)] * 2


def mesh_batches(seed: int, tok, cfg: ModelConfig) -> list[dict]:
    """MESH_STEPS seeded bs16 batches of flow texts at L=128."""
    texts = [flow_to_text(r) for r in flow_records(seed + 91, B_TRAIN * MESH_STEPS)]
    enc = tok.batch_encode(texts, max_len=cfg.max_len)
    labels = np.random.default_rng(seed + 92).integers(0, 2, len(texts)).astype(np.int32)
    return [
        {"input_ids": enc["input_ids"][i:i + B_TRAIN], "attention_mask": enc["attention_mask"][i:i + B_TRAIN],
         "labels": labels[i:i + B_TRAIN]}
        for i in range(0, len(texts), B_TRAIN)
    ]


def mesh_steps(trainer, params: dict, batches: list[dict]) -> tuple:
    """The trainer's state after one train step per batch, its losses and
    the seconds a step took (synchronized)."""
    state = trainer.init_state(params=params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        state, loss = trainer.train_step(state, b)
        losses.append(loss.to("cuda:0"))
    torch.cuda.synchronize()
    return state, torch.stack(losses).float().cpu().numpy(), (time.perf_counter() - t0) / len(batches)


def leaf_deviation(a: dict, b: dict, sat: float) -> tuple[float, int, int, int, list]:
    """Two host-param trees: (max |a - b|, elements outside atol 2e-6 +
    rtol 1e-5·|b|, of those the ones beyond ``sat``, all elements, the
    three leaves with the most elements outside)."""
    fa, fb = wire.flatten_params(a), wire.flatten_params(b)
    dev, out, beyond, total, where = 0.0, 0, 0, 0, []
    for k in fa:
        d = np.abs(np.asarray(fa[k], np.float64) - np.asarray(fb[k], np.float64))
        bad = d > 2e-6 + 1e-5 * np.abs(np.asarray(fb[k], np.float64))
        dev, total = max(dev, float(d.max())), total + d.size
        out += int(bad.sum())
        beyond += int((d > sat).sum())
        if bad.any():
            where.append((int(bad.sum()), k, float(d.max())))
    return dev, out, beyond, total, [(k, n, f"{m:.2e}") for n, k, m in sorted(where, reverse=True)[:3]]


def mesh_train(seed: int, card: str, cfg: ModelConfig, tok) -> None:
    """(a) MeshTrainer and FsdpMeshTrainer on two slots of the card against
    the one-device Trainer on the same 9 batches and weights."""
    params = init_params(cfg, torch.Generator().manual_seed(seed + 93))
    batches = mesh_batches(seed, tok, cfg)
    mesh = make_host_mesh(2, devices=two_slots())
    train_cfg = TrainConfig()
    off = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    # The JAX tests' bound (atol 2e-6 + rtol 1e-5) is for fp32, their
    # comparison's dtype. At full width a few elements' gradients are
    # rounding noise (the attention key biases' are 0 in exact arithmetic;
    # of 67M others, a handful cross 0 in a step): Adam divides such a
    # gradient by its own magnitude, so the two sides step by up to lr with
    # the noise's own sign (tests/test_torch_federated.py's docstring).
    # Held: the loss within rtol 1e-5; every element within the bound but
    # at most 1e-5 of them, and those within that saturation, 2·lr·steps.
    # In bf16 every slot's gradient takes its own bf16 rounding, which Adam
    # amplifies the same way on many more elements: reported, not bounded.
    sat = 2 * train_cfg.learning_rate * MESH_STEPS
    for label, mcfg in (("fp32", cfg.replace(compute_dtype="float32", **off)), ("bf16", cfg.replace(**off))):
        ref, ref_loss, ref_s = mesh_steps(Trainer(mcfg, train_cfg, device="cuda"), params, batches)
        ref_host = params_to_jax(ref.params)
        for cls in (MeshTrainer, FsdpMeshTrainer):
            st, loss, sec = mesh_steps(cls(mcfg, train_cfg, mesh=mesh), params, batches)
            dev, out, beyond, total, where = leaf_deviation(params_to_jax(st.params), ref_host, sat)
            lrel = float(np.max(np.abs(loss - ref_loss) / np.abs(ref_loss)))
            print(f"mesh (a): {card}: {cls.__name__} {label} dropout off, 2 slots on cuda:0, {MESH_STEPS} steps "
                  f"({sec * 1e3:.1f} ms/step, one device {ref_s * 1e3:.1f}): max|param - one device| {dev:.3e}; "
                  f"{out} of {total} elements outside atol 2e-6 + rtol 1e-5 ({out / total:.2e}; {beyond} beyond "
                  f"{sat:.1e}), most in {where}; max loss rel diff {lrel:.3e}", flush=True)
            check(np.isfinite(loss).all(), f"{cls.__name__} {label} losses {loss}")
            if label == "fp32":
                check(lrel <= 1e-5 and out <= 1e-5 * total and beyond == 0, f"{cls.__name__} fp32 trajectory off the "
                      f"one-device one: loss rel {lrel}, {out} elements outside the bound, {beyond} beyond {sat}")
    # The deployed configuration, dropout on: every slot's forward with K1
    # dropout, K2 and K3 in its backward; the static bytes a slot holds.
    bytes_ = {}
    for cls in (MeshTrainer, FsdpMeshTrainer):
        before = counts_read()  # a delta: the phase's own count keeps running
        st, loss, sec = mesh_steps(cls(cfg, train_cfg, mesh=mesh), params, batches)
        got = {k: v - before[k] for k, v in counts_read().items()}
        bytes_[cls.__name__] = device_tree_bytes((st.params, st.opt_state))
        want = cfg.n_layers * 2 * MESH_STEPS
        print(f"mesh (a): {card}: {cls.__name__} bf16 dropout on: {sec * 1e3:.1f} ms/step, losses "
              f"{np.round(loss, 4).tolist()}; launches {got}", flush=True)
        check(np.isfinite(loss).all(), f"{cls.__name__} losses {loss}")
        check(got["flash_fwd_dropout"] == got["flash_bwd_dkdv"] == got["flash_bwd_dq"] == want,
              f"{cls.__name__}: K1-dropout/K2/K3 {got} for {MESH_STEPS} steps on 2 slots (want {want} each)")
        if cls is FsdpMeshTrainer:
            check(all(isinstance(v, ShardedLeaf) and len(v.shards) in (1, 2) for v in st.params.values()),
                  "FSDP params not sharded at rest")
    ratio = bytes_["FsdpMeshTrainer"] / bytes_["MeshTrainer"]
    print(f"mesh (a): {card}: static bytes on a slot (params + Adam): replicated {bytes_['MeshTrainer'] / 1e6:.2f} MB, "
          f"FSDP {bytes_['FsdpMeshTrainer'] / 1e6:.2f} MB (ratio {ratio:.4f})", flush=True)
    check(ratio <= 0.6, f"FSDP slot bytes ratio {ratio}")


def mesh_serve(seed: int, card: str, cfg: ModelConfig, tok) -> None:
    """(b) The sharded ScoreEngine against the replicated one, then a
    sharded FleetReplica's rolling reload under load."""
    params = init_params(cfg, torch.Generator().manual_seed(seed + 94))
    mesh = make_host_mesh(2, devices=two_slots())
    rep = ScoreEngine(cfg, params, pad_id=tok.pad_id, buckets=BUCKETS)
    shard = ScoreEngine(cfg, params, pad_id=tok.pad_id, buckets=BUCKETS, mesh=mesh)
    texts = [flow_to_text(r) for r in flow_records(seed + 95, 128)]
    enc = tok.batch_encode(texts, max_len=cfg.max_len)
    same = []
    for n in (1, 8, 32, 128, 5):
        a, b = rep.score(enc["input_ids"][:n], enc["attention_mask"][:n]), shard.score(enc["input_ids"][:n], enc["attention_mask"][:n])
        same.append((n, b[2], bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2])))
    ratio = device_tree_bytes(shard.snapshot()[0]) / device_tree_bytes(rep.snapshot()[0])
    print(f"mesh (b): {card}: sharded engine (2 slots) bit-equal to the replicated one at (n, bucket) "
          f"{[(n, bk) for n, bk, ok in same if ok]}; slot bytes ratio {ratio:.4f}", flush=True)
    check(all(ok for *_, ok in same), f"sharded probs differ from the replicated engine's: {same}")
    check(ratio <= 0.6, f"sharded engine slot bytes ratio {ratio}")
    shard.warmup()
    params2 = {k: v + 1e-3 for k, v in params.items()}
    shard.swap(params2, round_id=2)
    for n in (1, 3, 8, 32, 128):
        check(shard.score(enc["input_ids"][:n], enc["attention_mask"][:n])[3] == 2, "swap did not publish round 2")
    check(shard.ledger.recompiles() == [] and shard.ledger.compile_counts("serving.gather") == {("gather",): 1},
          f"sharded swap: recompiles {shard.ledger.recompiles()}, gather {shard.ledger.compile_counts('serving.gather')}")
    del rep, shard
    replica = FleetReplica(0, cfg, params, tok, round_id=1, buckets=(1, 8, 32), mesh=mesh).start()
    fleet = ServingFleet([replica], probe_interval_s=0.2).start()
    try:
        out, errors = {}, []

        def loader() -> None:
            try:
                out.update(run_load("127.0.0.1", fleet.port, texts, concurrency=8, requests=512, timeout=300))
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        t = threading.Thread(target=loader)
        t.start()
        time.sleep(0.3)
        sweep = fleet.rolling_reload(params2, round_id=2)
        t.join(timeout=300)
        check(not t.is_alive(), "the load thread hung")
        if errors:
            raise errors[0]
        with ScoringClient("127.0.0.1", fleet.port, timeout=60) as c:
            after = c.score(text=texts[0])
        print(f"mesh (b): {card}: sharded FleetReplica rolling reload under {out['scored']} closed-loop requests: "
              f"rejected {out['rejected']}, swap {[round(s['swap_s'] * 1e3, 1) for s in sweep['replicas']]} ms; "
              f"round after {after['round']}; recompiles {replica.engine.ledger.recompiles()}", flush=True)
        check(out["scored"] == 512 and out["rejected"] == 0, f"load {out['scored']} scored, {out['rejected']} rejected")
        check(after["round"] == 2 and replica.engine.ledger.recompiles() == [], "the sharded replica did not roll to round 2")
    finally:
        fleet.close()


def refused(argv: list[str]) -> str:
    """The SystemExit message the port's CLI gives ``argv`` (fails if it runs)."""
    try:
        args = build_parser().parse_args(argv)
        args.fn(args)
    except SystemExit as e:
        return str(e)
    fail(f"{argv[0]} {' '.join(argv[1:])} was not refused")


def mesh_cli(seed: int, card: str, cfg: ModelConfig, tok, work: str) -> dict[str, int]:
    """(c) The mesh flags through the port's CLI: the refusals of a mesh
    this card cannot hold, then ``client --data-parallel 2 --fsdp`` (two
    rounds: the second reply streams into the sink) and ``infer-serve
    --data-parallel 2 --fsdp`` with the host's slots given as two on the
    card."""
    base = ["--preset", "distilbert", "--attention-impl", "flash", "--device", "cuda"]
    client = ["client", "--client-id", "0", "--host", "127.0.0.1", "--port", "1", *base]
    msgs = {
        "client --data-parallel 1 --fsdp": (refused([*client, "--data-parallel", "1", "--fsdp"]), JAX_FSDP_ONE),
        "client --data-parallel 2": (refused([*client, "--synthetic", "64", "--data-parallel", "2"]),
                                     "host mesh 2 needs 2 local devices, have 1"),
        "infer-serve --data-parallel 1 --fsdp": (refused(["infer-serve", "--registry-dir", work, "--data-parallel", "1",
                                                          "--fsdp", *base]), JAX_SERVE_FSDP_ONE),
        "infer-serve --data-parallel 2 --fsdp": (refused(["infer-serve", "--registry-dir", work, "--data-parallel", "2",
                                                          "--fsdp", *base]), "host mesh 2 needs 2 local devices, have 1"),
        "federated --data-parallel 2": (refused(["federated", "--data-parallel", "2", *base]),
                                        "--data-parallel 2 exceeds the 1 available devices"),
    }
    for what, (got, want) in msgs.items():
        print(f"mesh (c): {what}: refused: {got!r}", flush=True)
        check(got == want, f"{what}: {got!r}, want the JAX package's {want!r}")
    total = zero_launches()
    real = mesh_mod.local_devices
    mesh_mod.local_devices = lambda device=None: two_slots() if resolve_device(device).type == "cuda" else real(device)
    try:
        zero_with_fold()
        server = build_round_server(build_parser().parse_args(
            ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "1", "--timeout", "600", "--device", "cuda"]
        ))
        res, errors = {}, []

        def run() -> None:
            try:
                res.update(run_client(build_parser().parse_args([
                    "client", "--client-id", "0", "--num-clients", "2", "--host", "127.0.0.1", "--port", str(server.port),
                    *base, "--synthetic", "2400", "--epochs", "1", "--rounds", "2", "--seed", str(seed),
                    "--timeout", "600", "--data-parallel", "2", "--fsdp", "--output-dir", os.path.join(work, "mesh-client"),
                ])))
            except BaseException as e:  # re-raised below, after the join
                errors.append(e)

        with server:
            st = threading.Thread(target=server.serve, args=(2,))
            ct = threading.Thread(target=run)
            for t in (st, ct):
                t.start()
            for t in (ct, st):
                t.join(timeout=900)
        check(not st.is_alive() and not ct.is_alive(), "mesh client round hung")
        if errors:
            raise errors[0]
        add_launches(total, read_with_fold())
        trainer, rounds = res["trainer"], res["rounds"]
        shapes = [r["exchange"]["reply_shape"] for r in rounds]
        sunk = [type(v).__name__ for v in wire.flatten_params(rounds[1]["aggregate"], leaf_fn=lambda x: x).values()]
        up = wire.flatten_params(rounds[1]["uploaded"])
        agg = wire.flatten_params(trainer.host_params(res["state"]))  # the adopted aggregate, off its shards
        print(f"mesh (c): {card}: client --data-parallel 2 --fsdp: {type(trainer).__name__} over "
              f"{[str(d) for d in trainer.slots]}, {res['state'].step} steps, replies {shapes}, round-2 reply leaves "
              f"{sorted(set(sunk))}; aggregate crc {wire.flat_crc32(agg):#010x} vs its only upload "
              f"{wire.flat_crc32(up):#010x}; local acc {res['local']['Accuracy']:.2f}, aggregated "
              f"{res['aggregated']['Accuracy']:.2f}; launches {total}", flush=True)
        check(type(trainer).__name__ == "FsdpMeshTrainer" and len(trainer.slots) == 2, "the client's trainer is not FSDP on 2 slots")
        check(shapes[-1] == "stream" and set(sunk) == {"ShardedLeaf"}, "the streamed reply did not land on the shards")
        check(wire.flat_crc32(agg) == wire.flat_crc32(up), "the one-client aggregate differs from its upload")
        check(total["fold"] == 2 * 102, f"K4 launched {total['fold']} times for two rounds of 102 leaves")
        # infer-serve --data-parallel 2 --fsdp from a promoted artifact.
        reg = os.path.join(work, "mesh-registry")
        params = init_params(cfg, torch.Generator().manual_seed(seed + 96))
        publish(reg, params, 1, cfg)
        texts = [flow_to_text(r) for r in flow_records(seed + 97, 16)]
        zero_with_fold()
        srv = build_server(build_parser().parse_args(
            ["infer-serve", "--registry-dir", reg, "--host", "127.0.0.1", "--port", "0", "--data-parallel", "2",
             "--fsdp", "--buckets", "1,8,32", *base]
        ))
        with srv:  # warmup runs every bucket here
            replies = score_texts(srv.port, texts)
        add_launches(total, read_with_fold())
        lone = ScoreEngine(cfg, params, pad_id=tok.pad_id, buckets=(1, 8, 32))
        enc = tok.batch_encode(texts, max_len=cfg.max_len)
        ref = lone.score(enc["input_ids"], enc["attention_mask"])[0]
        diff = float(np.abs(np.array([r["prob"] for r in replies]) - ref).max())
        print(f"mesh (c): {card}: infer-serve --data-parallel 2 --fsdp: engine sharded over {srv.engine.n_shards} slots, "
              f"{len(replies)} replies, max|prob - lone engine| {diff:.3e} (bf16 atol 1e-2)", flush=True)
        check(srv.engine.mesh is not None and srv.engine.n_shards == 2 and diff <= 1e-2, f"sharded infer-serve: diff {diff}")
    finally:
        mesh_mod.local_devices = real
    return total


def mesh_processes(seed: int, card: str, work: str) -> dict[str, int]:
    """(d) ``federated --coordinator`` as two processes sharing the card
    (gloo) against the one-process run of the same config."""
    common = ["federated", "--preset", "distilbert", "--attention-impl", "flash", "--device", "cuda",
              "--synthetic", "3200", "--num-clients", "2", "--partition", "disjoint", "--epochs", "1",
              "--rounds", "1", "--seed", str(seed)]
    one_out, one_reg = os.path.join(work, "fed1"), os.path.join(work, "fed1-reg")
    counts_zero()
    t0 = time.perf_counter()
    run_federated(build_parser().parse_args([*common, "--output-dir", one_out, "--registry-dir", one_reg]))
    one_s = time.perf_counter() - t0
    total = {**counts_read(), "fold": 0}
    two_out, two_reg = os.path.join(work, "fed2"), os.path.join(work, "fed2-reg")
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", MESH_WORKER, *common, "--output-dir", two_out, "--registry-dir", two_reg,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    two_s = time.perf_counter() - t0
    for i, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"federated process {i} exited {p.returncode}:\n{o[-3000:]}")
    backend = [ln.split("INFO ", 1)[-1] for o in outs for ln in o.splitlines() if "[MESH]" in ln]
    for ln in backend:
        print(f"mesh (d): {ln}", flush=True)
    check(len(backend) == 2 and all("backend gloo" in ln and "NCCL goes unexercised" in ln for ln in backend),
          f"backend lines {backend}")
    for o in outs:
        add_launches(total, json.loads([ln for ln in o.splitlines() if ln.startswith("LAUNCHES ")][-1][9:]))
    reg1, reg2 = ModelRegistry(one_reg), ModelRegistry(two_reg)
    p1 = reg1.load_params(reg1.list()[-1]["id"])
    p2 = reg2.load_params(reg2.list()[-1]["id"])
    dev = max(float(np.abs(np.asarray(p1[k], np.float64) - np.asarray(p2[k], np.float64)).max()) for k in p1)
    rows = {}
    for name in ("client0_aggregated_metrics.csv", "client1_aggregated_metrics.csv", "client1_local_metrics.csv"):
        with open(os.path.join(one_out, name)) as f1, open(os.path.join(two_out, name)) as f2:
            rows[name] = (f1.read().splitlines()[1], f2.read().splitlines()[1])
    print(f"mesh (d): {card}: two processes {two_s:.1f} s (one process in-process {one_s:.1f} s); aggregate "
          f"max|two processes - one| {dev:.3e} over {len(p1)} leaves; metrics rows {rows}; launches {total}", flush=True)
    check(p1.keys() == p2.keys() and dev <= 2e-6, f"the two-process aggregate is {dev} off the one-process one")
    for name, (a, b) in rows.items():
        va, vb = np.array(a.split(","), float), np.array(b.split(","), float)
        check(np.array_equal(va[[0, 2, 3, 4]], vb[[0, 2, 3, 4]]) and abs(va[1] - vb[1]) <= 1e-5 * abs(va[1]),
              f"{name}: one process {a}, two {b}")
    return total


def mesh_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 15: the mesh tier on the card: (a) the meshed and FSDP
    trainers on two slots, (b) sharded serving, (c) the mesh flags through
    the CLI, (d) the two-process ``federated``. Returns each kernel's
    launches during it."""
    t_phase = time.perf_counter()
    tok = default_tokenizer()
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        resolve_config,
    )

    cfg = resolve_config(build_parser().parse_args(["local", "--preset", "distilbert", "--attention-impl", "flash"]),
                         vocab_size=len(tok.vocab)).model
    check((cfg.dim, cfg.n_layers, cfg.attention_impl, cfg.compute_dtype) == (768, 6, "flash", "bfloat16"),
          f"not full width: {cfg}")
    total = zero_launches()
    times = {}
    with tempfile.TemporaryDirectory() as work:
        zero_with_fold()
        t = time.perf_counter()
        mesh_train(seed, card, cfg, tok)
        mesh_serve(seed, card, cfg, tok)
        add_launches(total, read_with_fold())
        times["(a)+(b)"] = time.perf_counter() - t
        t = time.perf_counter()
        add_launches(total, mesh_cli(seed, card, cfg, tok, work))
        times["(c)"] = time.perf_counter() - t
        t = time.perf_counter()
        add_launches(total, mesh_processes(seed, card, work))
        times["(d)"] = time.perf_counter() - t
    print(f"mesh: {card}: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f"; launches {total}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(all(total[k] > 0 for k in total), f"a kernel of the mesh path did not launch: {total}")
    return total

# The seq phase: the sequence-parallel trainer and the --seq-parallel verbs
# on seq slots of the one card (every slot names cuda:0, so the ring's K/V
# placements are no-ops and no speed-up can show).
SEQ_LEN = 512
SEQ_BATCH = 8
SEQ_STEPS = 3
SEQ_SLOTS = 8
SEQ_FLOWS = 8  # flow sentences joined into one 512-token window
SEQ_ARGS = ["--preset", "distilbert", "--device", "cuda", "--max-len", str(SEQ_LEN), "--seq-parallel", "2",
            "--synthetic", "1600", "--num-clients", "2", "--epochs", "1"]
SEQ_WORKER = r"""
import json, sys
import numpy as np
import torch
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.parallel import mesh, multihost
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.device import resolve_device
real = mesh.local_devices
def slots(device=None):
    return [torch.device("cuda", 0)] * 8 if resolve_device(device).type == "cuda" else real(device)
mesh.local_devices = multihost.local_devices = slots
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import build_parser, main
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.comm import run_client
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm import wire
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.ops import flash_attention as f
mode, dump, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
rc = 0
if mode == "client":
    res = run_client(build_parser().parse_args(argv))
    up, agg = wire.flatten_params(res["uploaded"]), wire.flatten_params(res["aggregate"])
    np.savez(dump, **{"up/" + k: np.asarray(v) for k, v in up.items()}, **{"agg/" + k: np.asarray(v) for k, v in agg.items()})
    print("TRAINER " + type(res["trainer"]).__name__ + " " + str(res["state"].step), flush=True)
else:
    rc = main(argv)
print("LAUNCHES " + json.dumps({"flash_fwd": f.FWD_LAUNCHES, "flash_fwd_dropout": f.FWD_DROPOUT_LAUNCHES,
      "flash_bwd_dkdv": f.DKDV_LAUNCHES, "flash_bwd_dq": f.DQ_LAUNCHES}), flush=True)
sys.exit(rc)
"""


@contextlib.contextmanager
def card_seq_slots():
    """The mesh's and multihost's ``local_devices`` name SEQ_SLOTS slots
    on cuda:0 while the block runs (the CPU's slots unchanged)."""
    real_mesh, real_host = mesh_mod.local_devices, multihost_mod.local_devices

    def slots(device=None):
        return [torch.device("cuda", 0)] * SEQ_SLOTS if resolve_device(device).type == "cuda" else real_mesh(device)

    mesh_mod.local_devices = multihost_mod.local_devices = slots
    try:
        yield
    finally:
        mesh_mod.local_devices, multihost_mod.local_devices = real_mesh, real_host


def seq_windows(seed: int, tok, clients: int, rows: int) -> TokenizedSplit:
    """``[clients, rows, 512]`` windows: each row joins SEQ_FLOWS flow
    sentences (about 512 tokens, the tail padded), seeded labels."""
    n = clients * rows
    texts = [flow_to_text(r) for r in flow_records(seed, n * SEQ_FLOWS)]
    enc = tok.batch_encode([" ".join(texts[i * SEQ_FLOWS:(i + 1) * SEQ_FLOWS]) for i in range(n)], max_len=SEQ_LEN)
    labels = np.random.default_rng(seed + 1).integers(0, 2, n).astype(np.int32)
    return TokenizedSplit(enc["input_ids"].reshape(clients, rows, SEQ_LEN),
                          enc["attention_mask"].reshape(clients, rows, SEQ_LEN), labels.reshape(clients, rows))


def seq_steps(mcfg: ModelConfig, seq: int, params: dict, stacked: TokenizedSplit, seed: int) -> tuple[np.ndarray, float, float]:
    """SEQ_STEPS lockstep steps of a 2-client FedSeqTrainer over 2 x seq
    slots of the card: the ``[steps, 2]`` losses, the first step's ms and
    the mean ms of the rest (synchronized)."""
    cfg = ExperimentConfig(model=mcfg, data=DataConfig(max_len=SEQ_LEN, batch_size=SEQ_BATCH), train=TrainConfig(seed=seed),
                           fed=FedConfig(num_clients=2), mesh=MeshConfig(clients=2, seq=seq))
    trainer = FedSeqTrainer(cfg, device="cuda", mesh=make_seq_mesh(2, 1, seq, devices=[torch.device("cuda", 0)] * (2 * seq)))
    state = trainer.init_state(params=params)
    losses, ms = [], []
    for batch in federated_batches(stacked, SEQ_BATCH, seed=seed, epoch=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(state, batch)
        losses.append(loss.cpu().numpy())  # synchronizes
        ms.append((time.perf_counter() - t0) * 1e3)
    return np.stack(losses), ms[0], float(np.mean(ms[1:]))


def seq_train(seed: int, card: str, tok) -> None:
    """(a) FedSeqTrainer at max_len 512 over 1, 2 and 4 seq slots, dropout
    on (attention dropout included): the fp32 losses of SEQ_STEPS steps at
    seq 2 and 4 within 2e-4 of seq 1 and off the dropout-off run's; the
    ring forward within 2e-4 of the dot path at the same weights (fp32,
    dropout off); bf16 deviations printed; step times at each seq."""
    from torch.func import functional_call

    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models.distilbert import (
        SeqContext,
    )

    base = ModelConfig.distilbert_base(vocab_size=len(tok.vocab), max_len=SEQ_LEN, attention_impl="ring")
    check((base.dim, base.n_layers, base.n_heads, base.max_len) == (768, 6, 12, SEQ_LEN), f"not full width: {base}")
    check(min(base.dropout, base.attention_dropout, base.head_dropout) > 0.0, f"dropout off: {base}")
    params = init_params(base, torch.Generator().manual_seed(seed + 101))
    stacked = seq_windows(seed + 102, tok, 2, SEQ_BATCH * SEQ_STEPS)
    real = float(stacked.attention_mask.mean())
    off = dict(dropout=0.0, attention_dropout=0.0, head_dropout=0.0)
    fp32 = base.replace(compute_dtype="float32")
    before = counts_read()
    runs = {}
    for label, mcfg in (("fp32", fp32), ("bf16", base)):
        for seq in (1, 2, 4):
            runs[label, seq] = seq_steps(mcfg, seq, params, stacked, seed)
            losses, first, ms = runs[label, seq]
            dev = float(np.abs(losses - runs[label, 1][0]).max())
            print(f"seq (a): {card}: FedSeqTrainer {label} dropout on, 2 clients x seq {seq} at L={SEQ_LEN} bs{SEQ_BATCH} "
                  f"({real:.3f} of the positions real): {ms:.1f} ms a lockstep step (first {first:.1f}); losses "
                  f"{np.round(losses, 5).tolist()}; max |loss - seq 1| {dev:.3e}", flush=True)
            check(np.isfinite(losses).all(), f"{label} seq {seq} losses {losses}")
            if label == "fp32":
                check(dev <= 2e-4, f"fp32 seq {seq} losses {dev} off seq 1's (bound 2e-4)")
    det, _, _ = seq_steps(fp32.replace(**off), 2, params, stacked, seed)
    gap = float(np.abs(det - runs["fp32", 2][0]).max())
    print(f"seq (a): {card}: fp32 dropout off at seq 2: max |loss - dropout on| {gap:.3e}", flush=True)
    check(gap > 1e-5, "the dropout-on trajectory is the dropout-off one")
    dot = model_skeleton(fp32.replace(attention_impl="dot", **off))
    ring = model_skeleton(fp32.replace(**off))
    leaves = {n: t.to("cuda") for n, t in params.items()}
    ids = torch.from_numpy(stacked.input_ids[0, :SEQ_BATCH]).long().cuda()
    mask = torch.from_numpy(stacked.attention_mask[0, :SEQ_BATCH]).long().cuda()
    cuda0 = torch.device("cuda", 0)
    with torch.no_grad():
        ref = functional_call(dot, leaves, (ids, mask))
        for seq in (2, 4):
            got = functional_call(ring, leaves, (ids, mask), {"seq": SeqContext(((cuda0,) * seq,))})
            diff = float((got - ref).abs().max())
            print(f"seq (a): {card}: ring forward over {seq} slots vs the dot path, fp32 dropout off: max |logit diff| "
                  f"{diff:.3e} (bound 2e-4)", flush=True)
            check(diff <= 2e-4, f"ring forward at seq {seq} {diff} off the dot path")
    got = {k: v - before[k] for k, v in counts_read().items()}
    check(not any(got.values()), f"flash kernels launched on ring steps: {got}")


def seq_cli(seed: int, card: str, work: str) -> None:
    """(b) ``federated --seq-parallel 2`` (two clients, two rounds, L=512):
    the metrics CSVs; round 2 resumed from round 1's checkpoint ends bit
    for bit where the uninterrupted run ended; a DP-FedAvg round at noise 0
    against the plain mean of the same round."""
    import shutil

    common = ["federated", *SEQ_ARGS, "--seed", str(seed), "--unweighted"]
    ck, ck1 = os.path.join(work, "seq-ck"), os.path.join(work, "seq-ck1")
    t0 = time.perf_counter()
    res = run_federated(build_parser().parse_args([*common, "--rounds", "2", "--checkpoint-dir", ck,
                                                    "--output-dir", os.path.join(work, "seq-out")]))
    wall = time.perf_counter() - t0
    trainer = res["trainer"]
    mcfg = trainer.cfg.model  # the trainer's: it forces the ring path
    check(isinstance(trainer, FedSeqTrainer) and trainer.mesh.devices.shape == (2, 1, 2), f"trainer {type(trainer).__name__}")
    check((mcfg.dim, mcfg.n_layers, mcfg.max_len, mcfg.attention_impl) == (768, 6, SEQ_LEN, "ring"), f"config {mcfg}")
    for path in res["metrics_csvs"]:
        with open(path) as f:
            header, values = f.read().strip().splitlines()
        check(header == "Accuracy,Loss,Precision,Recall,F1-Score" and all(np.isfinite(float(v)) for v in values.split(",")),
              f"{path}: {header!r} {values!r}")
    check(len(res["metrics_csvs"]) == 4 and len(res["history"]) == 2, f"{res['metrics_csvs']}")
    fits = [round(h.seconds["fit"], 3) for h in res["history"]]
    shutil.copytree(ck, ck1, ignore=lambda d, names: ["2"] if os.path.samefile(d, ck) else [])
    again = run_federated(build_parser().parse_args([*common, "--rounds", "2", "--checkpoint-dir", ck1,
                                                      "--output-dir", os.path.join(work, "seq-resumed")]))
    same = all(torch.equal(res["state"].params[n], again["state"].params[n]) for n in res["state"].params)
    check(again["start_round"] == 1, f"resumed from round {again['start_round']}")
    dp = run_federated(build_parser().parse_args([*common, "--rounds", "1", "--dp-clip", "1e6", "--dp-noise-multiplier", "0",
                                                   "--output-dir", os.path.join(work, "seq-dp")]))
    with Checkpointer(ck) as c:
        r1 = c.restore_params(step=1, client=0)
    dp_dev = max(float((dp["state"].params[n][0].detach().cpu() - r1[n]).abs().max()) for n in r1)
    print(f"seq (b): {card}: federated --seq-parallel 2, 2 clients x 2 rounds at L={SEQ_LEN}: {wall:.1f} s (fit {fits} s), "
          f"CSVs {[os.path.basename(p) for p in res['metrics_csvs']]}; round 2 resumed from round 1 bit-equal {same}; "
          f"DP-FedAvg (clip 1e6) at noise 0 vs the plain mean: max |diff| {dp_dev:.3e}", flush=True)
    check(same, "the resumed round 2 differs from the uninterrupted one")
    check(isinstance(dp["trainer"], FedSeqTrainer) and dp["trainer"]._dp_seed is not None, "the DP round did not run DP-FedAvg")
    check(dp_dev <= 2e-6, f"DP aggregate at noise 0 {dp_dev} off the plain mean")


def seq_worker(mode: str, dump: str, argv: list[str]) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    return subprocess.Popen([sys.executable, "-c", SEQ_WORKER, mode, dump, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def finish(procs: list[subprocess.Popen], what: str) -> list[str]:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{what} process {i} exited {p.returncode}:\n{o[-3000:]}")
    return outs


def worker_launches(out: str) -> dict[str, int]:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("LAUNCHES ")][-1][9:])


def seq_round(seed: int, card: str, work: str) -> dict[str, int]:
    """(c) ``serve`` on the card and two ``client --seq-parallel 2``
    processes, one round: the clients' fedseq trainers launch no flash
    kernel, K4 folds the 102 leaves, and the aggregate's crc is the plain
    fold's of the two uploads."""
    server = build_round_server(build_parser().parse_args(
        ["serve", "--host", "127.0.0.1", "--port", "0", "--num-clients", "2", "--timeout", "600", "--device", "cuda"]
    ))
    dumps = [os.path.join(work, f"seq-client{i}.npz") for i in range(2)]
    fold_mod.FOLD_LAUNCHES = 0
    t0 = time.perf_counter()
    with server:
        st = threading.Thread(target=server.serve, args=(1,))
        st.start()
        procs = [seq_worker("client", dumps[i], [
            "client", "--client-id", str(i), "--host", "127.0.0.1", "--port", str(server.port), *SEQ_ARGS,
            "--rounds", "1", "--seed", str(seed), "--timeout", "600", "--output-dir", os.path.join(work, "seq-round"),
        ]) for i in range(2)]
        outs = finish(procs, "seq client")
        st.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not st.is_alive(), "the seq round's server hung")
    launches = zero_launches()
    launches["fold"] = fold_mod.FOLD_LAUNCHES
    for o in outs:
        add_launches(launches, worker_launches(o))
    trainers = [ln[8:] for o in outs for ln in o.splitlines() if ln.startswith("TRAINER ")]
    data = [np.load(d) for d in dumps]
    ups = [{k[3:]: z[k] for k in z.files if k.startswith("up/")} for z in data]
    aggs = [{k[4:]: z[k] for k in z.files if k.startswith("agg/")} for z in data]
    ref = {k: fold_mod.fold_reference([torch.from_numpy(u[k]) for u in ups], [np.float32(0.5)] * 2).numpy() for k in ups[0]}
    crc, want = wire.flat_crc32(aggs[0]), wire.flat_crc32(ref)
    print(f"seq (c): {card}: serve + two client --seq-parallel 2 processes ({trainers}), one round at L={SEQ_LEN}: "
          f"{wall:.1f} s; {len(ups[0])} leaves; aggregate crc {crc:#010x}, the plain fold of the uploads {want:#010x}; "
          f"launches {launches}", flush=True)
    check(all(t.startswith("FedSeqClientTrainer") for t in trainers) and len(trainers) == 2, f"client trainers {trainers}")
    check(wire.flat_crc32(aggs[1]) == crc and crc == want, "the seq round's aggregate is not the plain fold of its uploads")
    check(launches["fold"] == len(ups[0]) == 102, f"K4 launched {launches['fold']} times for {len(ups[0])} leaves")
    check(not any(launches[k] for k in launches if k != "fold"), f"flash kernels launched on ring steps: {launches}")
    return launches


def seq_processes(seed: int, card: str, work: str) -> None:
    """(d) ``federated --seq-parallel 2`` as two gloo processes sharing the
    card against the one-process run: the aggregate bit-equal."""
    common = ["federated", *SEQ_ARGS, "--rounds", "1", "--seed", str(seed), "--partition", "disjoint"]
    one_reg, two_reg = os.path.join(work, "seq-reg1"), os.path.join(work, "seq-reg2")
    t0 = time.perf_counter()
    run_federated(build_parser().parse_args([*common, "--output-dir", os.path.join(work, "seq-fed1"), "--registry-dir", one_reg]))
    one_s = time.perf_counter() - t0
    port = free_port()
    t0 = time.perf_counter()
    outs = finish([seq_worker("main", "-", [
        *common, "--output-dir", os.path.join(work, "seq-fed2"), "--registry-dir", two_reg,
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i),
    ]) for i in range(2)], "seq federated")
    two_s = time.perf_counter() - t0
    lines = [ln.split("INFO ", 1)[-1] for o in outs for ln in o.splitlines() if "[MESH]" in ln or "[FEDSEQ]" in ln]
    launches = [worker_launches(o) for o in outs]
    reg1, reg2 = ModelRegistry(one_reg), ModelRegistry(two_reg)
    p1, p2 = reg1.load_params(reg1.list()[-1]["id"]), reg2.load_params(reg2.list()[-1]["id"])
    dev = max(float(np.abs(np.asarray(p1[k], np.float64) - np.asarray(p2[k], np.float64)).max()) for k in p1)
    print(f"seq (d): {card}: two processes {two_s:.1f} s (one process in-process {one_s:.1f} s); {lines}; aggregate "
          f"max|two processes - one| {dev:.3e} over {len(p1)} leaves; launches {launches}", flush=True)
    check(sum("backend gloo" in ln for ln in lines) == 2 and sum("rings in-process" in ln for ln in lines) == 2, f"log lines {lines}")
    check(p1.keys() == p2.keys() and dev == 0.0, f"the two-process seq aggregate is {dev} off the one-process one")
    check(not any(v for la in launches for v in la.values()), f"flash kernels launched on ring steps: {launches}")


def seq_phase(seed: int, card: str) -> dict[str, int]:
    """Phase 16: sequence parallelism on the card: (a) FedSeqTrainer over
    1, 2 and 4 seq slots, (b) ``federated --seq-parallel 2``, (c) a TCP
    round of two ``client --seq-parallel 2`` processes, (d) the
    two-process ``federated --seq-parallel 2``. Returns each kernel's
    launches during it: K4 the round's folds, K1-K3 none (the ring is
    plain PyTorch)."""
    t_phase = time.perf_counter()
    tok = default_tokenizer()
    total = zero_launches()
    times = {}
    with tempfile.TemporaryDirectory() as work, card_seq_slots():
        zero_with_fold()
        t = time.perf_counter()
        seq_train(seed, card, tok)
        times["(a)"] = time.perf_counter() - t
        t = time.perf_counter()
        seq_cli(seed, card, work)
        times["(b)"] = time.perf_counter() - t
        add_launches(total, read_with_fold())
        t = time.perf_counter()
        add_launches(total, seq_round(seed, card, work))
        times["(c)"] = time.perf_counter() - t
        t = time.perf_counter()
        zero_with_fold()
        seq_processes(seed, card, work)
        add_launches(total, read_with_fold())
        times["(d)"] = time.perf_counter() - t
    print(f"seq: {card}: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f"; launches {total}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(total["fold"] > 0 and not any(total[k] for k in total if k != "fold"),
          f"the seq path's launches {total}: want K4 only")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's smoke run needs a card")

    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device_name = torch.cuda.get_device_name(0)
    print(f"torch: {device_name}, {torch.cuda.device_count()} card(s), torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("build")
    t0 = time.monotonic()
    built = _build.build()
    print(f"built {sorted(built) or 'nothing (cached)'} in {time.monotonic() - t0:.1f} s", flush=True)

    phase("kernel")
    k1 = kernel_phase(seed)

    phase("kernel-train")
    k1_drop, k2, k3 = train_kernel_phase(seed)

    phase("path")
    serve_launches = path_phase(seed, device_name)

    with tempfile.TemporaryDirectory() as work:
        ckpt_dir = os.path.join(work, "ckpt")
        phase("train")
        train_launches, res = train_phase(seed, card, ckpt_dir)
        phase("lifecycle")
        life_launches = lifecycle_phase(seed, card, res, ckpt_dir, work)
        del res
        phase("federated")
        fed_launches = federated_phase(seed, card, work)
        csv_path = os.path.join(work, "flows.csv")  # the lifecycle's 512 flows
        phase("train-options")
        opt_launches = train_options_phase(seed, card, work)
        phase("distill")
        distill_launches = distill_phase(seed, card, work, ckpt_dir, csv_path)
        phase("migrate")
        migrate_launches = migrate_phase(seed, card, work, ckpt_dir, csv_path)
        phase("privacy")
        privacy_launches = privacy_phase(seed, card, work)
        phase("dp-rounds")
        dp_launches = dp_rounds_phase(seed, card, work)
        phase("stream")
        stream_launches = stream_phase(seed, card, work)
    slice_launches = {
        k: opt_launches[k] + distill_launches[k] + migrate_launches[k] + privacy_launches[k] + dp_launches[k] + stream_launches[k]
        for k in opt_launches
    }
    early_fold = migrate_launches["fold"] + privacy_launches["fold"] + dp_launches["fold"] + stream_launches["fold"]
    k1["launches"] = serve_launches + train_launches["flash_fwd"] + life_launches + fed_launches["flash_fwd"] + slice_launches["flash_fwd"]
    for row in (k1_drop, k2, k3):
        row["launches"] = train_launches[row["name"]] + fed_launches[row["name"]] + slice_launches[row["name"]]
    print(
        f"launches: flash_fwd {serve_launches} (serving) + {train_launches['flash_fwd']} (evaluation) + {life_launches} "
        f"(predict, reload serving) + {fed_launches['flash_fwd']} (federated evaluation, predict, serving) + "
        f"{slice_launches['flash_fwd']} (train-options, distill, migrate, privacy, dp-rounds, stream); K1 dropout / K2 / K3 "
        f"{train_launches['flash_fwd_dropout']} (local) + {fed_launches['flash_fwd_dropout']} (federated) + "
        f"{slice_launches['flash_fwd_dropout']} / {slice_launches['flash_bwd_dkdv']} / {slice_launches['flash_bwd_dq']} "
        f"(train-options, distill, migrate, privacy, dp-rounds, stream); K4 {early_fold} (migrate, dp-rounds)",
        flush=True,
    )

    phase("kernel-fold")
    k4 = fold_kernel_phase(seed, card)

    phase("round")
    k4["launches"] = early_fold + round_phase(seed, card)

    phase("rounds")
    rounds_launches = rounds_phase(seed, card)
    k4["launches"] += rounds_launches["fold"]
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += rounds_launches[row["name"]]

    phase("serving")
    serving_launches = serving_phase(seed, card)
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += serving_launches[row["name"]]

    phase("obs")
    obs_launches = obs_phase(seed, card)
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += obs_launches[row["name"]]
    k4["launches"] += obs_launches["fold"]

    phase("control")
    control_launches = control_phase(seed, card)
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += control_launches[row["name"]]
    k4["launches"] += control_launches["fold"]

    phase("robust")
    robust_launches = robust_phase(seed, card)
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += robust_launches[row["name"]]
    k4["launches"] += robust_launches["fold"]

    phase("gates")
    gates_launches = gates_phase(seed, card)
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += gates_launches[row["name"]]
    k4["launches"] += gates_launches["fold"]

    phase("mesh")
    mesh_launches = mesh_phase(seed, card)
    for row in (k1, k1_drop, k2, k3):
        row["launches"] += mesh_launches[row["name"]]
    k4["launches"] += mesh_launches["fold"]

    phase("seq")
    k4["launches"] += seq_phase(seed, card)["fold"]

    print(json.dumps({"kernels": [k1, k1_drop, k2, k3, k4]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
