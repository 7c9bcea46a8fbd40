from ignis_jax.medium.union import (  # noqa: F401
    medium_coefficients, medium_eval, medium_eval_inf, medium_sample,
    phase_eval, phase_sample,
)
