"""The port's render_image against JAX render_image(fused_shading=True) on the
glossy Cornell (mirror + glass) with MIS and Russian roulette: the config-2
estimator. The gate and helpers are those of test_torch_pathtracer.py."""

from test_torch_pathtracer import _compare, _render_both


def test_render_image_cornell_glossy_mis_rr_matches_jax():
    _compare(*_render_both("glossy", mis=True, rr=True))
