"""Measurement scripts of the port, run as modules on the card (the JAX
package's ``scripts/`` counterparts)."""
