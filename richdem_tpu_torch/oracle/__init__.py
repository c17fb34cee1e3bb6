"""Serial host references: copies of the JAX package's JAX-free
``oracle/`` modules (Priority-Flood fill and its variants, flow
directions, accumulation, flat resolution, terrain attributes, Lindsay
breaching and Orlandini's path-sequential D8-LTD/LAD).  The API's
``BreachDepressions`` falls back to ``oracle/breach.py`` when the native
engine cannot be built, and ``FlowDirections(method="Orlandini")`` runs
``oracle/orlandini.py``."""
