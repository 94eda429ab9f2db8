"""The port's host runtime. Only ``transport.Address`` is here so far:
the actor runtime, the transports and timers are still to be ported."""
