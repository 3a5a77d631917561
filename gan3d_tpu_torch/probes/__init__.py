"""Probes: small kernels that each exercise one construct of the card."""
