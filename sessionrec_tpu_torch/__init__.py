"""sessionrec_tpu_torch — the PyTorch/CUDA port of ``sessionrec_tpu``.

The JAX package stays the reference; this package mirrors its module
layout (``data/``, ``graph/``, ``models/``, ``ops/``, ``train/``,
``utils/``, ``cli.py``) so each module's counterpart is found at the same
relative path.  It imports ``torch`` and ``numpy`` and nothing of JAX.

Implemented so far: MSGIFSR order-1 training on one device.  The fused
catalog cross-entropy (``ops/xent.py``) runs hand-written CUDA kernels
(``csrc/xent.cu``) on CUDA tensors and its plain PyTorch version on CPU
tensors.
"""

__version__ = "0.1.0"
