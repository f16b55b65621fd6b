"""Training: the loop, the single-device step, optimizers and schedules,
and the frozen-feature cache."""

from .feature_cache import FrozenFeatureCache, swin_feature_shape  # noqa: F401
from .loop import train  # noqa: F401
from .trainer import Trainer  # noqa: F401
