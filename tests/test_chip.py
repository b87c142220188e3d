"""chip_smoke.py: its seeded data, host reference and phases at tiny
sizes on the CPU, its refusal to run without a GPU, and (marked ``gpu``)
its phases at full size on a GPU."""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from runlmc_tpu.lmc import grid


def test_fx2007_data_shapes_and_holdouts():
    xss, yss, txs, tys = cs.fx2007_data(0)
    assert len(xss) == len(yss) == len(txs) == cs.FX_D
    assert sum(len(x) for x in xss) == 3054
    for d, x in enumerate(xss):
        assert len(x) == len(yss[d]) and np.all(np.diff(x) > 0)
        assert np.all(np.isfinite(yss[d])) and np.all(yss[d] > 0)
        if d in cs.FX_HOLDOUTS:
            lo, hi = cs.FX_HOLDOUTS[d]
            np.testing.assert_array_equal(txs[d], np.arange(lo, hi))
            assert len(tys[d]) == hi - lo
            assert not np.isin(x, txs[d]).any()
        else:
            assert len(txs[d]) == 0


def test_weather_data_shapes_and_holdouts():
    xss, yss, txs, tys = cs.weather_data(0)
    assert [len(x) for x in xss] == list(cs.WEATHER_N)
    assert sum(cs.WEATHER_N) == 15789
    for d, (x, tx) in enumerate(zip(xss, txs)):
        assert len(tys[d]) == len(tx) and len(yss[d]) == len(x)
        assert np.all(np.diff(x) > 0)
        assert x.min() >= 0 and x.max() < cs.WEATHER_DAYS
        if d in cs.WEATHER_HOLDOUTS:
            lo, hi = cs.WEATHER_HOLDOUTS[d]
            assert len(tx) > 100
            assert np.all((tx >= lo) & (tx <= hi))
            assert not np.any((x >= lo) & (x <= hi))
        else:
            assert len(tx) == 0


@pytest.mark.parametrize("make", [cs.fx2007_data, cs.weather_data])
def test_data_is_deterministic_per_seed(make):
    a, b, c = make(3), make(3), make(4)
    for part_a, part_b, part_c in zip(a, b, c):
        for u, v in zip(part_a, part_b):
            np.testing.assert_array_equal(u, v)
    assert not np.array_equal(a[1][0], c[1][0])


def test_main_refuses_to_run_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_host_reference_matches_the_device_operator():
    """host_ski_matrix (numpy, no device code) equals the model's own
    SKI operator densified."""
    from runlmc_tpu.lmc.grid import build_kski

    model, _ = cs.fx2007_model(0, D=2, m=24)
    K = build_kski(model.spec, model.params, model.grid_data,
                   model.data.lens)
    np.testing.assert_allclose(
        cs.host_ski_matrix(model), np.asarray(K.as_dense()),
        rtol=1e-10, atol=1e-12,
    )


@pytest.mark.parametrize("phase", ["fx2007", "weather", "beyond-cap"])
def test_phase_at_tiny_size(phase, monkeypatch):
    """Each phase's checks pass at a tiny size on the CPU (the
    beyond-cap phase by lowering the dense cap under its grid)."""
    tiny_n = (120, 120, 120, 120)
    if phase == "fx2007":
        line = cs.phase_fx2007(0, D=3, m=40)
    elif phase == "weather":
        line = cs.phase_weather(0, m=32, n_train=tiny_n)
        assert line["grid_modes"] == ["dense"]
    else:
        monkeypatch.setattr(grid, "DENSE_MAX_GRID", 64)
        line = cs.phase_weather(0, m=32, n_train=tiny_n, name=phase)
        assert line["grid_modes"] == ["fft"]
        assert line["checks"][0]["name"].startswith("fft_vs_tiled")
    assert all(c["ok"] for c in line["checks"])


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: RUNLMC_TEST_GPU=1 python -m pytest "
                    "tests/test_chip.py -m gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("phase", sorted(cs.PHASES))
def test_chip_smoke_phase_on_gpu(gpu, phase):
    cs.PHASES[phase](0)  # raises CheckFailed when a check fails
