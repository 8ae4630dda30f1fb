"""Developer tooling of the port: so far only the lock witness
(`lock_witness.py`, copied from `ray_tpu/devtools/lock_witness.py`),
which the runtime imports at start. The static gates (lint, check,
race) are not copied yet (ROADMAP)."""
