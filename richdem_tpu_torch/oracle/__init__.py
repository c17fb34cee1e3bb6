"""Serial host references the port's API dispatches to: copies of the JAX
package's ``oracle/flowdirs.py`` and ``oracle/orlandini.py`` (Orlandini's
path-sequential D8-LTD/LAD, the default host engine of
``FlowDirections(method="Orlandini")``)."""
