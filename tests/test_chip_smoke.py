"""chip_smoke.py's phases at toy scale on the CPU, its refusal to run off a
GPU, the compile-cache placement, and the `gpu`-marked bench-scale phases
that run only on the card."""

import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# Toy scale: ~1.8k scene voxels, ~5.7M votes at ref_point_df 20.
TOY = dict(n_model_raw=2000, n_total=5000, n_inst_pts=800)
TOY_RUN = dict(max_poses=128, ref_point_df=20, icp_iterations=4)


@pytest.fixture(scope="module")
def toy_problem():
    return chip_smoke.bench_problem(**TOY)


@pytest.fixture(scope="module")
def toy_ppf(toy_problem):
    return chip_smoke.ppf_phase(toy_problem, **TOY_RUN)


def test_ppf_phase_cpu(toy_problem, toy_ppf):
    """Both engines recover a planted instance through ost.match and
    match_with_state (the phase raises otherwise) and agree on the vote
    count; the state path ran no count pass (also checked inside)."""
    assert set(toy_ppf) == {"fast", "correlation"}
    assert int(toy_ppf["fast"].num_votes) == \
        int(toy_ppf["correlation"].num_votes) > 0


def test_kernel_phase_cpu(toy_problem):
    out = chip_smoke.kernel_phase(toy_problem, ref_point_df=20,
                                  n_ref_points=16)
    assert out["votes"] > 0
    assert out["flips"] / out["votes"] < 1e-4


def test_cli_phase_cpu(toy_problem, toy_ppf, capsys):
    chip_smoke.cli_phase(toy_problem, toy_ppf["fast"].pose, **TOY_RUN)
    assert "[cli] printed=1" in capsys.readouterr().out


def test_tsdf_phase_cpu(capsys):
    chip_smoke.tsdf_phase(dims=128, img=96)
    assert "[tsdf] dims=128" in capsys.readouterr().out


def test_four_card_phase_on_virtual_cpu_devices(toy_problem):
    assert len(jax.devices()) >= 4
    out = chip_smoke.four_card_phase(toy_problem, n_devices=4, **TOY_RUN)
    assert int(out["sharded"].num_votes) == int(out["single"].num_votes)


def test_main_off_gpu_exits_nonzero_without_result(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out
    assert "[device] platform=cpu" in out


@pytest.mark.parametrize("environ, platforms, want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "", None),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "cuda", None),
    ({}, "", "checkout"),
    ({"JAX_PLATFORMS": "cuda"}, None, "checkout"),
    ({}, "cpu", None),
])
def test_compile_cache_placement(environ, platforms, want):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise one
    fixed, gitignored directory inside the checkout — except on the CPU,
    which keeps the cache off."""
    import objective_slam_tpu as ost

    got = ost._cache_dir_to_set(environ, platforms)
    if want is None:
        assert got is None
        return
    assert got == ost.XLA_CACHE_DIR
    path = Path(got)
    assert path.parent == ROOT
    ignored = (ROOT / ".gitignore").read_text().split()
    assert f"{path.name}/" in ignored


@pytest.mark.gpu
def test_ppf_phase_bench_scale_gpu(gpu_device):
    chip_smoke.ppf_phase(chip_smoke.bench_problem())


@pytest.mark.gpu
def test_kernel_phase_bench_scale_gpu(gpu_device):
    out = chip_smoke.kernel_phase(chip_smoke.bench_problem())
    assert out["flips"] / out["votes"] < 1e-4
