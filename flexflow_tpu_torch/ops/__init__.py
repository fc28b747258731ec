"""Operator attrs, the lowering registry and the PyTorch lowerings."""
