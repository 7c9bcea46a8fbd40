from ignis_jax.bsdf.layered import (  # noqa: F401
    bsdf_eval, bsdf_pdf, bsdf_sample, prepare_surface,
)
from ignis_jax.bsdf.union import (  # noqa: F401
    bsdf_specular_mask, material_params, sample_draw_counts,
)
