"""PyTorch + CUDA port of ``multi_modal_foundation_model_tpu``.

The JAX package beside this one is the reference; this package mirrors its
layout (``ops``, ``models``, ``eval``, ``data``, ``utils``) and module names
so each module's counterpart is easy to find. It imports ``torch``,
``numpy`` and ``scipy`` only — never ``jax`` and nothing of the JAX
package — and keeps its own copies of what it needs from there.

Every Pallas kernel on a ported path becomes a hand-written Hopper kernel
under ``csrc/``, built from source at first use (``ops/build.py``). Each
kernel has a plain PyTorch version in the same module: CPU tensors take it,
CUDA tensors launch the kernel or raise.

Entry points run on the card unless the caller passes ``device="cpu"``
(``utils/device.py``).
"""

__version__ = "0.1.0"
