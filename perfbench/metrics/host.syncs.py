"""Host waits for the device a step: the ``cudaStreamSynchronize`` and
``cudaDeviceSynchronize`` calls that begin inside a layer span of the
program (the fixpoints' convergence reads, ``.item()``, ``torch.equal``),
counted where they happen.  The harness's own end-of-step synchronize
lies outside every span."""

from perfbench import spans

SPANS = spans.ALL


def read(run):
    return spans.syncs(run, SPANS)
