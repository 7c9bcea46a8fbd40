from ignis_jax.light.union import (  # noqa: F401
    env_emission_and_pdf, light_pdf_direct_solid, sample_light_direct,
    select_light_uniform,
)
