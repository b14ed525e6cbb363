"""Host-side helpers of the port (the native-library loader)."""
