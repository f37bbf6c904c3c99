"""Port parity: the checkpointer (``repro_torch.checkpoint``) against the
JAX reference's — one on-disk format, so a checkpoint written by either
package is restored by the other bit for bit (params and the AdamW state);
``verify``, ``latest_valid_step``, the ``.tmp_step_*`` sweep, ``keep``,
async saves, and restore onto the target's device and dtype.
"""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.core import fno as jfno
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import params_from_jax
from repro_torch.distributed import faults as flt


def _state(arch="fno2d", seed=0):
    """The reference's {"params", "opt"} of a reduced model after one
    AdamW update (non-zero moments), and the port's copy of it."""
    cfg = jget_config(arch, reduced=True)
    params = jfno.init_fno(jax.random.PRNGKey(seed), cfg)
    opt = JAdamW(lr=jconstant(1e-3))
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params)
    params, ostate = opt.update(grads, opt.init(params), params)
    jstate = {"params": params, "opt": ostate}
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = {"params": params_from_jax(np_state["params"]),
              "opt": {"m": params_from_jax(np_state["opt"]["m"]),
                      "v": params_from_jax(np_state["opt"]["v"]),
                      "step": torch.tensor(np.asarray(ostate["step"]))}}
    return jstate, tstate


def _equal_bits(tstate, jstate):
    tl = tree.leaves(tstate)
    jl = jax.tree_util.tree_leaves(jstate)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert t.dtype == torch.from_numpy(np.zeros(0, j.dtype)).dtype
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("arch", ["fno1d", "fno2d", "fno3d"])
def test_keys_are_the_references(arch):
    jstate, tstate = _state(arch)
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        JCheckpointer(dj).save(1, jstate)
        Checkpointer(dt).save(1, tstate)
        man = [json.load(open(os.path.join(d, "step_1", "manifest.json")))
               for d in (dj, dt)]
        assert man[1] == man[0]  # keys, checksums, shapes and dtypes


def test_port_restores_a_reference_checkpoint_bit_for_bit():
    jstate, tstate = _state(seed=3)
    _, target = _state(seed=4)  # another state of the same layout
    with tempfile.TemporaryDirectory() as d:
        JCheckpointer(d).save(5, jstate)
        ck = Checkpointer(d)
        assert ck.verify(5) and ck.latest_valid_step() == 5
        got = ck.restore(5, target)
    _equal_bits(got, jstate)
    assert tree.paths(got) == tree.paths(target)


def test_reference_restores_a_port_checkpoint_bit_for_bit():
    jstate, tstate = _state(seed=3)
    jtarget, _ = _state(seed=4)
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(2, tstate)
        ck = JCheckpointer(d)
        assert ck.verify(2) and ck.latest_valid_step() == 2
        got = ck.restore(2, jtarget)
    _equal_bits(tstate, got)


def test_restore_takes_the_targets_dtype():
    src = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, src)
        target = {"a": torch.zeros((2, 3), dtype=torch.bfloat16),
                  "b": [torch.zeros(2, dtype=torch.float64)]}
        got = ck.restore(1, target)
        assert got["a"].dtype == torch.bfloat16
        assert got["b"][0].dtype == torch.float64
        torch.testing.assert_close(got["a"].float(), src["a"])
        # a bfloat16 leaf is stored widened to float32, exactly
        ck.save(2, target | {"a": src["a"].to(torch.bfloat16)})
        man = json.load(open(os.path.join(d, "step_2", "manifest.json")))
        assert man["dtypes"]["a"] == "float32"
        back = ck.restore(2, target)
        assert torch.equal(back["a"], src["a"].to(torch.bfloat16))


def test_verify_and_latest_valid_step_skip_corrupt_steps():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, {"w": torch.ones(3)})
        ck.save(2, {"w": torch.full((3,), 2.0)})
        assert ck.steps() == [1, 2] and ck.latest_valid_step() == 2
        flt.corrupt_checkpoint(d, 2)
        assert ck.latest_step() == 2 and not ck.verify(2)
        assert ck.latest_valid_step() == 1
        assert JCheckpointer(d).latest_valid_step() == 1
        flt.corrupt_checkpoint(d, 1)
        assert ck.latest_valid_step() is None
        assert not ck.verify(7)  # a missing step is invalid, not an error
        with pytest.raises(IOError):
            ck.restore(2, {"w": torch.zeros(3)})


def test_init_sweeps_stale_tmp_dirs():
    with tempfile.TemporaryDirectory() as d:
        stale = os.path.join(d, ".tmp_step_7")
        os.makedirs(stale)
        with open(os.path.join(stale, "arrays.npz"), "wb") as f:
            f.write(b"half-written garbage")
        Checkpointer(d)
        assert not os.path.exists(stale)


def test_keep_prunes_the_oldest_steps():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, {"w": torch.full((2,), float(s))})
        assert ck.steps() == [3, 4]
        assert float(ck.restore(4, {"w": torch.zeros(2)})["w"][0]) == 4.0


def test_async_save_and_wait_surface_errors():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, {"w": torch.ones(4)}, blocking=False)
        ck.wait()
        assert ck.verify(1)
        ck.last_error = IOError("disk full")
        with pytest.raises(IOError, match="disk full"):
            ck.wait()
        ck.wait()  # an error is raised once
