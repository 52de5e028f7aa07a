"""PyTorch + CUDA port of the Sieve serving runtime (the ``repro`` package
is the JAX/Pallas reference it is held against).

The port imports ``torch`` and numpy only.  Modules mirror ``repro``'s
layout, so ``repro_torch.models.moe`` is the counterpart of
``repro.models.moe``; what the port needs from ``repro``'s numpy-only
modules is copied under the same relative path.

Entry points (``LM``, ``ServingEngine``) take ``device=`` and default to
``"cuda"``: without a GPU they raise unless the caller asks for the CPU.
"""

from .device import resolve_device  # noqa: F401
