"""pyjac_jax.ops subpackage."""
