"""Tile manifests (``layout.py``, a copy of the JAX package's), for the
CLI's ``merge`` verb.  The tiled two-pass programs and the sharded mesh
are not ported yet."""
