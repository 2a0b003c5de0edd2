"""The model stack as torch.nn: parameter specs, layers, KV caches, the
decoder and the model-level API."""
