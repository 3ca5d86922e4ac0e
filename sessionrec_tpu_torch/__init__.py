"""sessionrec_tpu_torch — the PyTorch/CUDA port of ``sessionrec_tpu``.

The JAX package stays the reference; this package mirrors its module
layout (``data/``, ``graph/``, ``models/``, ``ops/``, ``train/``,
``utils/``, ``cli.py``) so each module's counterpart is found at the same
relative path.  It imports ``torch`` and ``numpy`` and nothing of JAX.

Implemented: all four models (SRGNN, NISER+, LESSR, MSGIFSR at order 1
and as the WSDM'22 paper head) train, evaluate and serve on one device or
on a (data, model) mesh of processes (``parallel/``).  The fused catalog
cross-entropy (``ops/xent.py``) and the fused multi-order REnorm/fusion
loss (``ops/xent_multi.py``) run hand-written CUDA kernels
(``csrc/xent.cu``, ``csrc/xent_bwd.cu``, ``csrc/xent_multi.cu``) on CUDA
tensors, whole or on a catalog shard, and their plain PyTorch versions on
CPU tensors.
"""

__version__ = "0.1.0"
