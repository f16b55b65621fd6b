"""KLab MultiModalModel in PyTorch for NVIDIA Hopper: the port of the JAX
package ``klab_multimodalmodel_tpu``, which stays the reference.

This package imports nothing of the JAX package and never imports ``jax``.
Its entry points (``infer.captioner.Captioner``, the model constructors) run
on the card unless the caller passes ``device="cpu"``.
"""

from .config import Config, SwinV2Size, T5Size  # noqa: F401
