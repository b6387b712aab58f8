"""The learner's ``--checkify`` and ``--compile-cache`` against the JAX
package's.

``--checkify``: the JAX package's checkify-instrumented step
(``make_train_step(..., debug_checkify=True)``, ``errors=float_checks``)
and the port's (``train/checkify.py`` around the same update) get the same
seeded batch (``tests/test_torch_train.py``'s) with one entry poisoned, and
raise exactly in the same cases: a NaN raises in both; an infinity raises
where it makes a NaN and not where it only makes an infinity (a reward of
1e38 makes the loss inf and raises in neither). The op each names is the
JAX primitive's aten counterpart. A clean batch updates the params bit for
bit as the unchecked step does (f32 on the CPU: the checks read results and
change none), and the loss agrees with the JAX package's checked step at
rtol 1e-4. Fused mode with checkify is a ``ValueError`` in both learners;
the learner's epoch step (the reference's staged loop) checks each update
under checkify and trains the params bit for bit as unchecked.

``--compile-cache``: the native codec builds with ``g++`` into ``DIR`` and
a second process loads it with no rebuild (the library's mtime unchanged).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu_torch.train import ppo as pppo
from dotaclient_tpu_torch.train.checkify import FloatCheckError, checked
from tests.test_torch_common import flax_params, jax_policy, port_policy, to_torch
from tests.test_torch_train import batch_to, make_batch, ppo_configs

jppo = importlib.import_module("dotaclient_tpu.train.ppo")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _set(key, index, value):
    def poison(b):
        a = np.array(b[key])
        a[index] = value
        b[key] = a
    return poison


def _unit(value):
    def poison(b):
        obs = dict(b["obs"])
        u = np.array(obs["units"])
        u[0, 0, 0, 0] = value
        obs["units"] = u
        b["obs"] = obs
    return poison


def _carry(i, value):
    def poison(b):
        c = list(b["carry0"])
        row = np.array(c[i])
        row[0, 0] = value
        c[i] = row
        b["carry0"] = tuple(c)
    return poison


# case -> (poison, JAX primitive named, aten op named); None: no raise
CASES = {
    "clean": (lambda b: None, None, None),
    "nan_reward": (_set("rewards", (0, 0), np.nan), "add", "aten.add"),
    "inf_reward": (_set("rewards", (0, 0), np.inf), "sub", "aten.sub"),
    "neg_inf_reward": (_set("rewards", (0, 0), -np.inf), "sub", "aten.sub"),
    "huge_reward": (_set("rewards", (0, 0), 1e38), None, None),
    "inf_unit": (_unit(np.inf), "dot_general", "aten.addmm"),
    "neg_inf_behavior_logp": (_set("behavior_logp", (0, 0), -np.inf), "mul", "aten.mul"),
    "inf_behavior_logp": (_set("behavior_logp", (0, 0), np.inf), None, None),
    "inf_carry_h": (_carry(0, np.inf), "mul", "aten.mul"),
    "inf_carry_c": (_carry(1, np.inf), "dot_general", "aten.mm"),
}


@pytest.fixture(scope="module")
def setup():
    from dotaclient_tpu.parallel import make_mesh

    jcfg, pcfg = ppo_configs("default")
    params = flax_params(jcfg, seed=1)
    base = make_batch(pcfg, params, seed=0)
    jstep = jppo.make_train_step(jax_policy(jcfg)[0], jcfg, make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
                                 debug_checkify=True)
    return jcfg, pcfg, params, base, jstep


def poisoned(base, case):
    b = {k: (dict(v) if isinstance(v, dict) else v) for k, v in base.items()}
    CASES[case][0](b)
    return b


def run_jax(setup, batch):
    jcfg, _, params, _, jstep = setup
    state = jppo.init_train_state(jax.tree.map(jnp.asarray, params), jcfg.ppo)
    try:
        state, m = jstep(state, batch_to(batch, jnp.asarray))
        return None, float(m["loss"]), state
    except Exception as e:  # noqa: BLE001 - checkify's JaxRuntimeError
        return str(e), None, None


def run_port(setup, batch, debug_checkify=True):
    _, pcfg, params, _, _ = setup
    state = pppo.init_train_state(port_policy(pcfg, params), pcfg.ppo)
    step = pppo.make_train_step(dataclasses.replace(pcfg, health=dataclasses.replace(pcfg.health, enabled=True)),
                                debug_checkify=debug_checkify)
    try:
        state, m = step(state, batch_to(batch, lambda a: torch.from_numpy(np.array(a))))
        return None, m, state
    except FloatCheckError as e:
        return str(e), None, None


@pytest.mark.parametrize("case", sorted(CASES))
def test_checked_step_raises_where_the_references_does(setup, case):
    batch = poisoned(setup[3], case)
    jerr, jloss, _ = run_jax(setup, batch)
    perr, pm, _ = run_port(setup, batch)
    _, jprim, aten = CASES[case]
    assert (jerr is None) == (perr is None), (case, jerr, perr)
    if jprim is None:
        assert jerr is None and perr is None
        loss = float(pm["loss"])
        assert (np.isfinite(loss) and np.isfinite(jloss)) or loss == jloss == np.inf, (loss, jloss)
    else:
        assert f"nan generated by primitive: {jprim}" in jerr
        assert perr.startswith(f"nan generated by primitive: {aten}."), perr


def test_clean_checked_step_is_the_unchecked_step(setup):
    """Bit for bit at f32 on the CPU (the checks read, never write), and the
    JAX package's checked step's loss at rtol 1e-4."""
    batch = setup[3]
    _, jloss, _ = run_jax(setup, batch)
    _, m_checked, s_checked = run_port(setup, batch)
    _, m_plain, s_plain = run_port(setup, batch, debug_checkify=False)
    assert set(m_checked) == set(m_plain)
    for k in m_plain:
        assert torch.equal(m_checked[k], m_plain[k]), k
    for (name, a), (_, b) in zip(s_checked.policy.state_dict().items(), s_plain.policy.state_dict().items()):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(float(m_checked["loss"]), jloss, rtol=1e-4)
    assert not torch.is_anomaly_enabled()   # restored after the step


def test_checks_see_the_backward_and_the_optimizer():
    """A NaN made in the backward alone (sqrt's gradient at 0 divides by 0)
    and one made by the optimizer's update raise, naming the op."""
    x = torch.zeros(3, requires_grad=True)

    def backward_only():
        return torch.autograd.grad(torch.sqrt(x).sum() * 0.0, x)

    with pytest.raises(FloatCheckError, match="aten"):
        checked(backward_only)()
    p = torch.nn.Parameter(torch.ones(2))
    opt = torch.optim.Adam([p], lr=0.1, foreach=True)

    def poisoned_step():
        p.grad = torch.tensor([float("nan"), 0.0])
        opt.step()

    with pytest.raises(FloatCheckError, match="nan generated by primitive: aten._foreach"):
        checked(poisoned_step)()
    with pytest.raises(FloatCheckError, match="division by zero"):
        checked(lambda: torch.ones(2) / torch.tensor([1.0, 0.0]))()


def test_fused_mode_with_checkify_is_a_value_error_in_both_learners():
    from dotaclient_tpu.config import RunConfig as JaxConfig
    from dotaclient_tpu.train.learner import Learner as JaxLearner
    from dotaclient_tpu_torch.config import RunConfig
    from dotaclient_tpu_torch.train.learner import Learner

    with pytest.raises(ValueError, match="checkify instruments the buffered train step") as jax_err:
        JaxLearner(JaxConfig(), actor="fused", debug_checkify=True)
    with pytest.raises(ValueError, match="checkify instruments the buffered train step") as port_err:
        Learner(RunConfig(), actor="fused", device="cpu", debug_checkify=True)
    assert str(port_err.value) == str(jax_err.value)


def tiny_learner_config(**ppo):
    from dotaclient_tpu_torch.config import ModelConfig, RunConfig
    from dotaclient_tpu_torch.train.learner import smoke_config

    cfg = smoke_config(RunConfig())
    return dataclasses.replace(cfg, model=ModelConfig(unit_embed_dim=8, hidden_dim=8, hero_embed_dim=4,
                                                      dtype="float32"),
                               ppo=dataclasses.replace(cfg.ppo, minibatches=2, epochs_per_batch=2, **ppo))


def test_staged_loop_trains_the_epoch_steps_rows():
    """checkify checks each update of the one epoch step (the reference's
    staged loop): the same rows from the same permutation stream, so the
    params after equal the unchecked learner's bit for bit, with or without
    ``fused_epoch`` (which picks nothing in the port)."""
    from dotaclient_tpu_torch.train.learner import Learner

    params = {}
    for label, kw, ppo in (("epoch", {}, {}), ("checkify", {"debug_checkify": True}, {}),
                           ("checkify_unfused", {"debug_checkify": True}, {"fused_epoch": False})):
        learner = Learner(tiny_learner_config(**ppo), device="cpu", **kw)
        assert learner.epoch_step is not None
        try:
            learner.train(8)
        finally:
            learner.close()
        params[label] = learner.policy.state_dict()
        assert learner.state.step == 8 and learner._mb_draws == 4
    for label in ("checkify", "checkify_unfused"):
        for name, t in params["epoch"].items():
            assert torch.equal(params[label][name], t), (label, name)


def _cli(args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.train.learner", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": ROOT, **(env or {})})


def test_cli_checkify_raises_on_a_poisoned_update_naming_the_op(tmp_path):
    out = _cli(["--smoke", "--steps", "2", "--device", "cpu", "--checkify"],
               env={"DOTA_FAULTS": "learner.nan_grad@1"})
    assert out.returncode != 0
    assert "FloatCheckError: nan generated by primitive: aten." in out.stderr, out.stderr[-2000:]
    refused = _cli(["--smoke", "--device", "cpu", "--checkify", "--actor", "fused"])
    assert refused.returncode == 2 and "--actor fused never calls" in refused.stderr


def test_compile_cache_builds_the_codec_once(tmp_path):
    """Two processes with the same fresh DIR: the first builds the native
    codec with g++ into DIR/native, the second loads it with no build."""
    cache = str(tmp_path / "cache")
    code = ("import json; from dotaclient_tpu_torch.train.learner import use_compile_cache; "
            f"print('CACHE ' + json.dumps(use_compile_cache({cache!r}, kernels=False)))")
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": ROOT})
        assert out.returncode == 0, out.stderr[-2000:]
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("CACHE ")][-1]
        codec = json.loads(line[len("CACHE "):])["codec"]
        runs.append((codec, os.path.getmtime(codec["path"])))
    (first, t1), (second, t2) = runs
    assert first["how"] == "built" and second["how"] == "loaded" and t1 == t2
    assert first["path"] == second["path"] and first["path"].startswith(os.path.join(cache, "native"))
    # the package's own build directory is untouched by default, and a
    # process refuses to move it after the library is loaded
    from dotaclient_tpu_torch.native import build as native_build
    from dotaclient_tpu_torch.ops import build as ops_build

    assert native_build.BUILD_DIR.endswith(os.path.join("native", "_build"))
    assert ops_build.BUILD_DIR.endswith(os.path.join("ops", "_build"))
    native_build.load_library()
    with pytest.raises(RuntimeError, match="already loaded"):
        native_build.set_build_dir(cache)
