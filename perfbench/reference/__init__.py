"""The benchmark's plain reference: PyTorch only, in float32 or float64.

It imports nothing of the program under test and takes nothing that the
program made, except where a module says so (``quinn_mfd``: the judged
fill).  Each ``<entry>.py`` gives ``reference(z, nodata, out, cfg,
control=False)``, the entry's outputs as the reference works them out
(``control=True``: in bfloat16, the precision below the configuration's
float32), and ``judge(out, ref, z, nodata, cfg)``, the numbers compared,
by name, each held to the limit of that name in the configuration.
"""
