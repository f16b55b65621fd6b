"""Online serving: dynamic-batching caption inference over HTTP.

The port of the JAX package's ``serve/``:

  * one dispatcher thread owns the device; HTTP threads only decode their
    request and wait, so device work is never interleaved;
  * requests are coalesced into batches (``window_ms`` x ``max_batch``) and
    padded to power-of-two batch buckets, so the card sees
    log2(max_batch) + 1 batch shapes per generation-parameter group;
  * every bucket runs once (``warmup``) before the server reports healthy;
  * ``ContinuousCaptionService`` keeps one resident decode batch that
    requests join and leave at chunk boundaries; ``ReplicatedCaptionService``
    routes over one replica per device.
"""

from .batcher import BatchStats, DynamicBatcher
from .continuous import ContinuousCaptionService
from .replicas import ReplicatedCaptionService
from .service import CaptionService

__all__ = ["BatchStats", "DynamicBatcher", "CaptionService",
           "ContinuousCaptionService", "ReplicatedCaptionService"]
