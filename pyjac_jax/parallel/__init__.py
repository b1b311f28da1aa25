"""pyjac_jax.parallel subpackage."""
