"""PyTorch ops: encodings, sampling, compositing, metrics."""
