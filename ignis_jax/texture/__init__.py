from ignis_jax.texture.eval import eval_texture_stack, resolve_color  # noqa: F401
