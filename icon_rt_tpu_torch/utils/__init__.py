"""Primitives: counter-based LCG, color packing, PNG IO, host vector math and
the native host-module loader."""
