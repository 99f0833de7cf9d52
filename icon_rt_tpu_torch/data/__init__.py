"""Datasets: binary .ic IO and synthetic icosphere scenes (numpy, host)."""
