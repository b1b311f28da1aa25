"""pyjac_jax.core subpackage."""
