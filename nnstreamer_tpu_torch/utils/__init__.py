"""Utilities: performance probes (peaks, MFU, phase splits) and the on-card
smoke lane."""
