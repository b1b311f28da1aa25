"""Profiling/cost-model, peak-table, timing and compile-cache tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyjac_jax.profiling import (DEVICE_PEAKS, cost_estimate, device_peaks,
                                 speed_of_light, timed)

H100 = 'NVIDIA H100 80GB HBM3'


def test_cost_estimate_scales(small_packed):
    c_rates = cost_estimate(small_packed, 'rates')
    c_jac = cost_estimate(small_packed, 'jacobian')
    assert c_jac.flops_per_state > 5 * c_rates.flops_per_state
    assert c_jac.arithmetic_intensity() > 0
    with pytest.raises(ValueError):
        cost_estimate(small_packed, 'nope')


def test_speed_of_light(small_packed):
    sol = speed_of_light(small_packed, H100)
    c = cost_estimate(small_packed, 'jacobian', 8)
    assert sol['compute_bound_evals_per_sec'] == pytest.approx(
        67e12 / c.flops_per_state)
    assert sol['memory_bound_evals_per_sec'] == pytest.approx(
        3.35e12 / c.bytes_per_state)
    f32 = speed_of_light(small_packed, H100, dtype_bytes=4)
    assert f32['memory_bound_evals_per_sec'] > \
        sol['memory_bound_evals_per_sec']


def test_peak_table_h100():
    """The H100's published peaks (NVIDIA data sheet, SXM5)."""
    p = device_peaks(H100)
    assert p == DEVICE_PEAKS[H100]
    assert p['f64_flops'] == 34e12 and p['f64_tensor_flops'] == 67e12
    assert p['f32_flops'] == 67e12 and p['mem_bytes_per_s'] == 3.35e12


@pytest.mark.parametrize('kind', ['cpu', 'NVIDIA A100-SXM4-80GB', 'NVIDIA H100 PCIe',
                                  ''])
def test_unknown_device_kind_raises(small_packed, kind):
    """No default peak: a device missing from the table is an error."""
    with pytest.raises(ValueError, match='no published peak'):
        device_peaks(kind)
    with pytest.raises(ValueError, match='no published peak'):
        speed_of_light(small_packed, kind)


def test_timed(small_packed, small_states):
    from pyjac_jax.ops.dydt import dydt_conp
    st = small_states
    y = jnp.asarray(st['y'][:16])
    P = jnp.asarray(st['P'][:16])
    fn = jax.jit(lambda p, yy: dydt_conp(small_packed, 0.0, p, yy))
    out, dt = timed(fn, P, y, iters=2)
    assert dt > 0
    assert out.shape == (16, small_packed.n_species)


def test_timed_waits_for_every_output(monkeypatch):
    """timed() blocks on the full result, every leaf, on every call."""
    seen = []
    real = jax.block_until_ready

    def spy(x):
        seen.append(len(jax.tree.leaves(x)))
        return real(x)

    monkeypatch.setattr(jax, 'block_until_ready', spy)
    fn = jax.jit(lambda a: (a + 1.0, {'b': a * 2.0}))
    _, dt = timed(fn, jnp.ones(4), iters=3, warmup=2)
    assert seen == [2] * 5 and dt > 0


def test_libgen_conv_export(small_packed, small_states, tmp_path):
    """AOT export of the CONV kernels."""
    from pyjac_jax.libgen import generate_library, load_library
    from pyjac_jax.ops.dydt import dydt_conv
    from pyjac_jax.ops.thermo import eval_conc
    out = str(tmp_path / 'libconv')
    generate_library(small_packed, out, kernels=('dydt',), conp=False,
                     platforms=('cpu',))
    lib = load_library(out)
    assert lib['manifest']['conp'] is False
    st = small_states
    sel = np.linspace(0, len(st['T']) - 1, 6).astype(int)
    T = jnp.asarray(st['T'][sel])
    P = jnp.asarray(st['P'][sel])
    Y = jnp.asarray(st['Y_full'][sel, :-1])
    _, _, rho, _ = eval_conc(small_packed, T, P, Y)
    y = jnp.asarray(st['y'][sel])
    f = lib['dydt'](rho, y)
    f_ref = dydt_conv(small_packed, 0.0, rho, y)
    scale = float(jnp.abs(f_ref).max())
    np.testing.assert_allclose(np.asarray(f) / scale,
                               np.asarray(f_ref) / scale, atol=1e-12)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', before)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the cache stays where it
    says and no code sets another location."""
    from pyjac_jax.compile_cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch,
                                              restore_cache_dir):
    """Without it, the cache is one fixed, git-ignored directory of the
    checkout: the same path on every call and in every process."""
    import pathlib

    from pyjac_jax.compile_cache import CACHE_DIR, enable_compile_cache
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert enable_compile_cache() == CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    assert pathlib.Path(CACHE_DIR).parent == repo
    assert enable_compile_cache() == CACHE_DIR
    ignored = (repo / '.gitignore').read_text().split()
    assert pathlib.Path(CACHE_DIR).name in ignored
