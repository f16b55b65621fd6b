"""Model modules: layers, T5, SwinV2 and the multimodal cascade."""
