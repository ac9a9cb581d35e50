"""The port's Mamba-1 block (``repro_torch.models.mamba``) against the JAX
package's ``repro.models.mamba`` on the reference test's small SSM dims
(d 24, d_inner 48, state 4, conv width 3, dt rank 8), float32, with the
reference's ``init_params`` weights and numpy-seeded inputs.

Against JAX at 1e-5: ``mamba_forward`` with both inner scans and chunks
3, 4, 6 and 12 (output and both state leaves), a prompt as long as the
conv tail, the ``REPRO_MAMBA_INNER`` override, ``mamba_decode_step`` on
a nonzero state and ``mamba_state_shape``. In the port alone, at the
reference's own tolerances (tests/test_moe_mamba.py): stepping the
recurrence token by token equals the chunked scan (2e-4 / 2e-3), and the
scan does not depend on the chunk (1e-4 / 1e-3). A prompt shorter than
the conv tail, where the reference's forward raises, is held to the
port's own stepped decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import mamba as jmb
from repro.models.common import init_params as jinit
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models import mamba as mb

TOL = 1e-5
CHUNKS = [3, 4, 6, 12]


def _cfgs():
    kw = dict(name="t", family="ssm", num_layers=1, d_model=24, num_heads=0,
              num_kv_heads=0, d_ff=0, vocab_size=64,
              layer_pattern=("mamba",), param_dtype="float32")
    ssm = dict(state_dim=4, conv_width=3, expand=2, dt_rank=8)
    return (JArchConfig(ssm=JSSMConfig(**ssm), **kw),
            ArchConfig(ssm=SSMConfig(**ssm), **kw))


JCFG, CFG = _cfgs()


def _params():
    jp = jinit(jmb.mamba_spec(JCFG, jnp.float32), jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _x(seed, b, s):
    return (np.random.default_rng(seed).standard_normal(
        (b, s, CFG.d_model)) * 0.5).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_spec_matches_reference():
    """Leaf shapes, dtypes and initializers: A_log, D and dt_bias stay
    float32 in a bfloat16 model, initialized ones, ones and zeros."""
    jspec = jmb.mamba_spec(JCFG, jnp.bfloat16)
    tspec = mb.mamba_spec(CFG, torch.bfloat16)
    assert sorted(tspec) == sorted(jspec)
    for k, s in tspec.items():
        assert s.shape == jspec[k].shape, k
        assert s.init == jspec[k].init, k
        want = torch.float32 if k in ("A_log", "D", "dt_bias") else \
            torch.bfloat16
        assert s.dtype == want, k
    assert {k: tspec[k].init for k in ("A_log", "D", "dt_bias")} == {
        "A_log": "ones", "D": "ones", "dt_bias": "zeros"}


@pytest.mark.parametrize("inner", ["sequential", "associative"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_forward_matches_reference(inner, chunk):
    jp, tp = _params()
    x = _x(1, 2, 12)
    jy, (jconv, jh) = jmb.mamba_forward(jp, jnp.asarray(x), JCFG,
                                        chunk=chunk, inner=inner)
    ty, (tconv, th) = mb.mamba_forward(tp, torch.from_numpy(x), CFG,
                                       chunk=chunk, inner=inner)
    close(ty.numpy(), jy)
    close(tconv.numpy(), jconv)
    close(th.numpy(), jh)
    assert th.dtype == torch.float32


@pytest.mark.parametrize("s", [2, 5])
def test_forward_conv_tail_matches_reference(s):
    """Prompts of 2 tokens (exactly the conv tail of cw - 1 = 2) and of
    5 (a chunk of 5 found by the divisor search from 128)."""
    jp, tp = _params()
    x = _x(2, 2, s)
    jy, (jconv, jh) = jmb.mamba_forward(jp, jnp.asarray(x), JCFG)
    ty, (tconv, th) = mb.mamba_forward(tp, torch.from_numpy(x), CFG)
    assert tuple(tconv.shape) == tuple(jconv.shape) == (2, 2, 48)
    close(ty.numpy(), jy)
    close(tconv.numpy(), jconv)
    close(th.numpy(), jh)


def test_prompt_shorter_than_the_conv_tail():
    """One token, shorter than the tail of cw - 1 = 2. The reference's
    zero pad is ``zeros_like(x1[:, :cw - 1])``, one row here, so its
    convolution comes out empty and its scan raises; the port pads the
    full ``cw - 1`` rows, its forward equals the token stepped from a
    zero state, and its tail is the token behind one zero row, as the
    reference builds the tail."""
    jp, tp = _params()
    x = _x(7, 2, 1)
    with pytest.raises(TypeError):
        jmb.mamba_forward(jp, jnp.asarray(x), JCFG)
    ty, (tconv, th) = mb.mamba_forward(tp, torch.from_numpy(x), CFG)
    conv_shape, h_shape = mb.mamba_state_shape(CFG, 2)
    sy, (sconv, sh) = mb.mamba_decode_step(
        tp, torch.from_numpy(x), (torch.zeros(conv_shape),
                                  torch.zeros(h_shape)), CFG)
    close(ty.numpy(), sy.numpy())
    close(th.numpy(), sh.numpy())
    close(tconv.numpy(), sconv.numpy())
    assert not tconv[:, 0].any()


def test_inner_override_from_environment(monkeypatch):
    """``REPRO_MAMBA_INNER`` picks the inner scan when the caller does
    not, in both packages; an unknown name raises in the port."""
    jp, tp = _params()
    x = _x(3, 1, 8)
    monkeypatch.setenv("REPRO_MAMBA_INNER", "associative")
    jy, _ = jmb.mamba_forward(jp, jnp.asarray(x), JCFG, chunk=4)
    ty, _ = mb.mamba_forward(tp, torch.from_numpy(x), CFG, chunk=4)
    close(ty.numpy(), jy)
    monkeypatch.setenv("REPRO_MAMBA_INNER", "parallel")
    with pytest.raises(ValueError, match="unknown inner scan"):
        mb.mamba_forward(tp, torch.from_numpy(x), CFG)


def test_decode_step_matches_reference():
    """Three steps from a nonzero state (a 7-token prefill's)."""
    jp, tp = _params()
    x = _x(4, 2, 10)
    _, jstate = jmb.mamba_forward(jp, jnp.asarray(x[:, :7]), JCFG)
    _, tstate = mb.mamba_forward(tp, torch.from_numpy(x[:, :7]), CFG)
    for t in range(7, 10):
        jy, jstate = jmb.mamba_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                           jstate, JCFG)
        ty, tstate = mb.mamba_decode_step(tp, torch.from_numpy(
            x[:, t:t + 1]), tstate, CFG)
        close(ty.numpy(), jy)
        close(tstate[0].numpy(), jstate[0])
        close(tstate[1].numpy(), jstate[1])


@pytest.mark.parametrize("batch", [1, 3])
def test_state_shape_matches_reference(batch):
    assert mb.mamba_state_shape(CFG, batch) == jmb.mamba_state_shape(
        JCFG, batch) == ((batch, 2, 48), (batch, 48, 4))


def test_decode_matches_forward():
    """Stepping the recurrence token by token equals the chunked scan,
    the reference's ``test_mamba_decode_matches_forward`` on the port."""
    _, tp = _params()
    x = torch.from_numpy(_x(5, 2, 12))
    y_full, final = mb.mamba_forward(tp, x, CFG, chunk=4)
    conv_shape, h_shape = mb.mamba_state_shape(CFG, 2)
    state = (torch.zeros(conv_shape), torch.zeros(h_shape))
    ys = []
    for t in range(12):
        y_t, state = mb.mamba_decode_step(tp, x[:, t:t + 1], state, CFG)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(),
                               y_full.numpy(), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(state[1].numpy(), final[1].numpy(),
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("inner", ["sequential", "associative"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunk_invariance(chunk, inner):
    """The chunked scan does not depend on the chunk size, the
    reference's ``test_mamba_chunk_invariance`` on the port."""
    _, tp = _params()
    x = torch.from_numpy(_x(6, 1, 12))
    y_ref, _ = mb.mamba_forward(tp, x, CFG, chunk=12, inner="sequential")
    y, _ = mb.mamba_forward(tp, x, CFG, chunk=chunk, inner=inner)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-4,
                               rtol=1e-3)
