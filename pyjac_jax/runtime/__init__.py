"""pyjac_jax.runtime subpackage (native C++ runtime components)."""
