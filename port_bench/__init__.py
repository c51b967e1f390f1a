"""The port's benchmark: closed-loop MPC fleets on one H100, driven by the
files under ``cells/``, ``configs/``, ``traffic/`` and ``metrics/``
(:mod:`.harness`). Imports nothing of JAX or of the JAX package."""
