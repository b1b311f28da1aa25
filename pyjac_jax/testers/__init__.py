"""pyjac_jax.testers subpackage."""
