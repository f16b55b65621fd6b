"""Dataset constants used by captioning."""

COCO_PROMPT = "What does th image describe ?"  # sic: the reference's prompt
