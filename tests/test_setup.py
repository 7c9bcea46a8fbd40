"""Set-up pieces: compile-cache rules and the generated scenes."""

from pathlib import Path

import pytest

from ignis_jax.api import compile_cache_config
from ignis_jax.scene.generated import demo_scene, sphere_field

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_cache_env_dir_is_left_to_jax(platform):
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}
    cfg = compile_cache_config(platform, env, REPO)
    assert "jax_compilation_cache_dir" not in cfg
    if platform == "cpu":
        assert cfg == {"jax_enable_compilation_cache": False}
    else:
        assert cfg == {}


def test_cache_gpu_uses_fixed_dir_in_checkout():
    cfg = compile_cache_config("gpu", {}, REPO)
    d = Path(cfg["jax_compilation_cache_dir"])
    assert d == REPO / "build" / "jax_cache"
    assert compile_cache_config("gpu", {}, REPO) == cfg   # never moves
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_cache_cpu_disabled():
    assert compile_cache_config("cpu", {}, REPO) == {
        "jax_enable_compilation_cache": False}


def test_sphere_field_triangle_count():
    from ignis_jax.scene.compile import load_and_compile
    sc = load_and_compile(sphere_field(n_spheres=2, subdiv=1),
                          width=8, height=8)
    # subdivision-1 icospheres have 80 faces; the floor is 2 triangles
    assert sc.tables["tri_v0"].shape[0] == 2 * 80 + 2


def test_demo_scene_covers_the_material_and_light_union():
    sc = demo_scene()
    assert {b["type"] for b in sc["bsdfs"]} == {
        "diffuse", "dielectric", "conductor"}
    assert {lt["type"] for lt in sc["lights"]} == {"area", "env"}
