"""Package version + provenance identifiers (reference counterpart:
``include/richdem/common/version.hpp`` — SURVEY.md §2.1).

The port keeps the JAX package's version number, so the
``PROCESSING_HISTORY`` lines of both packages read alike."""

__version__ = "0.1.0"

#: Printed by the CLI banner, mirroring the reference's program_identifier.
PROGRAM_IDENTIFIER = f"richdem_tpu_torch {__version__} (PyTorch/CUDA)"
