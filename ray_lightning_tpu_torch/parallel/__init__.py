"""Parallel layers of the port: the mixture-of-experts FFN on one device."""
