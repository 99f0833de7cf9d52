"""Frame loop, CLI flags, .xf IO and the transfer-function editor."""
