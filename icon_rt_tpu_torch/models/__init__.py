"""Scene state as NamedTuples of tensors: cells, transfer function, locator,
radial majorant bands."""
