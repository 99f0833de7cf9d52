"""Render operations: camera, ray ordering, launch params and the fast
radial-band tracker."""
