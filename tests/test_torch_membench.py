"""The paper's memory-benchmark cells: the port's plain version against
the JAX package's Pallas kernel (interpret mode) and its pure-jnp oracle
on the 8 cases of tests/test_kernels.py, rtol 1e-6 as there; the buffer
maker; and the timer's refusal to time the CPU.

The CUDA kernel runs only on a card (``test_cuda_*`` skip without one;
``chip_smoke.py`` phase 2 checks every cell on the card every run).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.membench.ops import make_buffer as jmake_buffer
from repro.kernels.membench.ops import membench as jmembench
from repro.kernels.membench.ref import membench_ref
from repro_torch.kernels import membench as tmb


@pytest.mark.parametrize("contentious", [True, False])
@pytest.mark.parametrize("write", [True, False])
@pytest.mark.parametrize("n_steps,repeats", [(4, 3), (16, 8)])
def test_plain_matches_pallas_and_oracle(contentious, write, n_steps,
                                         repeats):
    jbuf = jmake_buffer(max(8, n_steps))
    kw = dict(contentious=contentious, write=write, repeats=repeats)
    bk, sk = jmembench(jbuf, n_steps=n_steps, **kw)
    br, sr = membench_ref(jbuf, n_steps, **kw)
    buf = torch.from_numpy(np.asarray(jbuf).copy())
    bt, st = tmb.membench(buf, n_steps=n_steps, **kw)
    for b_want, s_want in ((bk, sk), (br, sr)):
        np.testing.assert_allclose(bt.numpy(), np.asarray(b_want),
                                   rtol=1e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(s_want),
                                   rtol=1e-6)
    # the input is not modified; the outputs have the kernel's shapes
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert bt.shape == buf.shape and st.shape == (n_steps,)


@pytest.mark.parametrize("n_steps", [0, 3, 8, 20])
def test_make_buffer_matches_reference(n_steps):
    want = np.asarray(jmake_buffer(n_steps))
    got = tmb.make_buffer(n_steps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (max(8, n_steps), tmb.LANE)


def test_make_buffer_from_a_generator_is_seeded():
    a = tmb.make_buffer(12, torch.Generator().manual_seed(5), device="cpu")
    b = tmb.make_buffer(12, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a, b) and a.shape == (12, tmb.LANE)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("seed", range(3))
def test_random_buffers_match_oracle(seed):
    """Uniform buffers (the reference's keyed make_buffer) at the
    noncontentious and contentious cells, against the jnp oracle on the
    same numbers."""
    rng = np.random.default_rng(seed)
    n_steps = int(rng.integers(1, 40))
    buf = rng.uniform(size=(max(8, n_steps), 128)).astype(np.float32)
    for cont in (True, False):
        for wr in (True, False):
            kw = dict(contentious=cont, write=wr, repeats=int(
                rng.integers(1, 50)))
            br, sr = membench_ref(jnp.asarray(buf), n_steps, **kw)
            bt, st = tmb.membench(torch.from_numpy(buf), n_steps=n_steps,
                                  **kw)
            np.testing.assert_array_equal(bt.numpy(), np.asarray(br))
            np.testing.assert_allclose(st.numpy(), np.asarray(sr),
                                       rtol=1e-6)


@pytest.mark.parametrize("n_steps", [0, 1, 7, 33])
def test_plain_contentious_write_matches_oracle(n_steps):
    """The cell the CUDA kernel runs as one CTA, step after step: row 0
    ends at repeats + n_steps - 1, step i's checksum is 128 (repeats +
    i), every other row is untouched."""
    rng = np.random.default_rng(n_steps)
    buf = rng.uniform(size=(max(8, n_steps), 128)).astype(np.float32)
    kw = dict(contentious=True, write=True, repeats=1000)
    br, sr = membench_ref(jnp.asarray(buf), n_steps, **kw)
    bt, st = tmb.membench(torch.from_numpy(buf), n_steps=n_steps, **kw)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(br))
    np.testing.assert_array_equal(st.numpy(),
                                  np.asarray(sr, np.float32).reshape(-1))
    np.testing.assert_array_equal(bt.numpy()[1:], buf[1:])
    assert st.shape == (n_steps,)


def test_membench_takes_no_check_keyword():
    """Nothing in a cell waits on another CTA, so there is no error word
    to check and no ``check=``."""
    with pytest.raises(TypeError, match="check"):
        tmb.membench(torch.zeros(8, 128), n_steps=4, contentious=True,
                     write=True, check=False)


def test_wrapper_checks_its_buffer():
    with pytest.raises(ValueError, match=r"\(R, 128\)"):
        tmb.membench(torch.zeros(8, 64), n_steps=4, contentious=True,
                     write=False)
    with pytest.raises(ValueError, match="one row per step"):
        tmb.membench(torch.zeros(8, 128), n_steps=9, contentious=False,
                     write=False)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tmb.membench(torch.zeros(8, 128, device="meta"), n_steps=4,
                     contentious=True, write=False)


def test_time_cell_never_times_the_cpu():
    with pytest.raises(RuntimeError, match="no CPU mode"):
        tmb.time_cell(8, contentious=True, write=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmb.time_cell(8, contentious=True, write=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("contentious", [True, False])
@pytest.mark.parametrize("write", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, contentious, write):
    buf = tmb.make_buffer(132, torch.Generator().manual_seed(1),
                          device=cuda_device)
    kw = dict(n_steps=132, contentious=contentious, write=write,
              repeats=1000)
    before = tmb.MEMBENCH.launches
    bk, sk = tmb.membench(buf, **kw)
    br, sr = tmb.membench_plain(buf.cpu(), **kw)
    assert tmb.MEMBENCH.launches == before + 1
    assert torch.equal(bk.cpu(), br)
    np.testing.assert_allclose(sk.cpu().numpy(), sr.numpy(), rtol=1e-6)
    assert tmb.time_cell(132, contentious=contentious, write=write,
                         repeats=100, device=cuda_device) > 0


@pytest.mark.parametrize("n_steps", [132, 1056])
@pytest.mark.parametrize("contentious", [True, False])
@pytest.mark.parametrize("write", [True, False])
def test_cuda_cells_at_the_benchmark_sizes(cuda_device, n_steps,
                                           contentious, write):
    """Every cell at 1 and 8 CTAs per SM (1000 repeats): the buffer
    bit-equal, the sums within rtol 1e-6 of the plain version."""
    buf = tmb.make_buffer(n_steps, torch.Generator().manual_seed(n_steps),
                          device=cuda_device)
    kw = dict(n_steps=n_steps, contentious=contentious, write=write,
              repeats=1000)
    bk, sk = tmb.membench(buf, **kw)
    br, sr = tmb.membench_plain(buf.cpu(), **kw)
    assert torch.equal(bk.cpu().view(torch.int32), br.view(torch.int32))
    np.testing.assert_allclose(sk.cpu().numpy(), sr.numpy(), rtol=1e-6)
