"""Fault injection for the real TCP tier (the port's copy of the JAX
package's ``faults/``): a seeded in-process fault proxy (:mod:`.proxy`),
the client personas (:mod:`.personas`), the ``scenario`` matrix runner
(:mod:`.scenario`) and the seeded mid-round relay kill
(:mod:`.deadrelay`). Every wire fault acts on the real socket protocol,
so a fault plan replays the same against a JAX or a port peer."""

from .deadrelay import DeadRelayFault  # noqa: F401
from .personas import PERSONA_NAMES, Persona, get_persona  # noqa: F401
from .proxy import CLEAN, FaultProxy, FaultSpec  # noqa: F401
