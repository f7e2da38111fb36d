"""Serving's mesh: what the port serves of a sharded spec, and what it
refuses by name.  The port serves in one process, unsharded
(``RunSpec.check_serves``, called by ``ServeSession`` and
``ServeEngine.from_spec``).

What is held:

* the refusals: tp > 1 for every serving family (JAX splits heads and
  vocabulary over 'model', with bf16 psums), the MoE family at pods * dp
  > 1 (JAX routes each data shard's rows with the capacity of that
  shard's token count), whisper with FSDP at pods * dp > 1 (JAX projects
  the encoder output with the un-gathered FSDP shard of x_wk/x_wv);
* the acceptance, against JAX's ServeSession on 2 host devices (one
  module-scoped subprocess, f32 SMOKE configs, the same numpy-seeded
  weights): paper_llama at dp 2 with FSDP and the recurrent families
  (zamba2_7b, xlstm_125m) at dp 2 serve JAX's sharded tokens; and the
  reason for the MoE refusal, pinned: JAX's deepseek_v3 prefill logits
  at dp 2 are not its dp-1 logits.
"""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_processes import _env, _wait
from test_torch_serve_families import cfg_pair, np_params
from test_torch_zamba import assert_rel
from repro_torch import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import ServeEngine
from repro_torch.tree import leaves_with_paths

ROOT = Path(__file__).resolve().parents[1]
SEED = 61
B, T, NEW = 4, 8, 4
SPAWN_TIMEOUT_S = 300
# a prompt batch's prefill logits relative to their largest entry (f32
# sums in other orders) and phase 5's rule for greedy tokens: equal up to
# the first position whose top-2 margin is thinner than 2 LOGIT_TOL
LOGIT_RTOL = 1e-4
LOGIT_TOL = 1e-3
FAMILIES = ["paper_llama", "phi35_moe_42b", "deepseek_v3_671b",
            "whisper_tiny", "zamba2_7b", "xlstm_125m"]
# served sharded by JAX and by the port unsharded: (arch, dp, fsdp)
ACCEPTED = {"dense_fsdp": ("paper_llama", 2, True),
            "zamba2": ("zamba2_7b", 2, False),
            "xlstm": ("xlstm_125m", 2, False)}
# deepseek_v3 at dp 1 and dp 2: the MoE family's per-shard routing
MOE_PROBE = {"moe_dp1": ("deepseek_v3_671b", 1, False),
             "moe_dp2": ("deepseek_v3_671b", 2, False)}


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def spec(arch: str, dp: int = 1, tp: int = 1, pods: int = 1,
         fsdp: bool = False) -> tapi.RunSpec:
    return tapi.RunSpec(arch=arch, smoke=True,
                        mesh=tapi.MeshSpec(dp=dp, tp=tp, pods=pods,
                                           fsdp=fsdp))


def serving_entry_points(s: tapi.RunSpec):
    """ServeSession and ServeEngine.from_spec of spec ``s`` on the CPU."""
    return (lambda: tapi.ServeSession(s, device="cpu"),
            lambda: ServeEngine.from_spec(s, device="cpu"))


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_refuses_tensor_parallelism(arch):
    for entry in serving_entry_points(spec(arch, tp=2)):
        with pytest.raises(tapi.SpecError, match="mesh.tp=2 .*tensor-"
                           "parallel serving .*sharded-serving slice"):
            entry()


@pytest.mark.parametrize("arch", ["phi35_moe_42b", "deepseek_v3_671b"])
@pytest.mark.parametrize("dp,pods", [(2, 1), (1, 2)], ids=["dp2", "pods2"])
def test_serving_refuses_the_moe_family_over_data_shards(arch, dp, pods):
    for entry in serving_entry_points(spec(arch, dp=dp, pods=pods)):
        with pytest.raises(tapi.SpecError, match="mesh.pods \\* mesh.dp = 2"
                           " .*capacity of its own token count"):
            entry()


def test_serving_refuses_whisper_with_fsdp_over_data_shards():
    """whisper with FSDP at dp 2 is refused (the reference's cross K/V
    uses an un-gathered shard); at dp 2 without FSDP, and with FSDP at
    dp 1 (nothing to shard), it serves."""
    for entry in serving_entry_points(spec("whisper_tiny", dp=2,
                                           fsdp=True)):
        with pytest.raises(tapi.SpecError, match="mesh.fsdp .*un-gathered"):
            entry()
    for s in (spec("whisper_tiny", dp=2), spec("whisper_tiny", fsdp=True)):
        sess = tapi.ServeSession(s, device="cpu")
        frames = torch.zeros((2, sess.cfg.enc_frames, sess.cfg.d_model))
        assert sess.generate([[1, 2], [3, 4]], 2, max_seq=32,
                             enc_frames=frames).shape == (2, 2)


def test_dense_serving_takes_data_parallel_meshes():
    """A dense spec at dp 4 (phase 4f's ``--mesh 4x1``), over pods, or
    with FSDP serves through both entry points."""
    for s in (spec("paper_llama", dp=4), spec("paper_llama", dp=2, pods=2),
              spec("paper_llama", dp=2, fsdp=True)):
        eng = ServeEngine.from_spec(s, device="cpu")
        assert eng.cfg.name == s.model_config().name
        assert tapi.ServeSession(s, params=eng.params, device="cpu").generate(
            [[1, 2, 3]], 2).shape == (1, 2)


# ------------------------------------------- acceptance against JAX
JAX_SCRIPT = textwrap.dedent('''
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import compat  # noqa: F401
    from repro import api, configs

    inp, out_path, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    data = dict(np.load(inp))
    out = {}
    for name, (arch, dp, fsdp) in cases.items():
        cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
        api.RunSpec.model_config = lambda self, cfg=cfg: cfg
        params = {}
        for k, v in data.items():
            if k.startswith(name + "/params/"):
                node = params
                parts = k.split("/")[2:]
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        sess = api.ServeSession(api.RunSpec(
            arch=arch, smoke=True,
            mesh=api.MeshSpec(dp=dp, fsdp=fsdp)), params=params)
        prompts = jnp.asarray(data[name + "/prompts"])
        out[name + "/tokens"] = np.asarray(sess.generate(prompts, %d))
        out[name + "/logits"] = np.asarray(sess.prefill(prompts)[0])
    np.savez(out_path, **out)
''' % NEW)


def case_inputs(name: str, arch: str) -> dict:
    _, cfg = cfg_pair(arch)
    inp = {f"{name}/params/" + "/".join(path): a for path, a in
           leaves_with_paths(np_params(cfg, SEED))}
    inp[f"{name}/prompts"] = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's ServeSession on 2 host devices for ACCEPTED and MOE_PROBE:
    each case's generate tokens and prefill logits; and the inputs."""
    d = tmp_path_factory.mktemp("serve_mesh")
    cases = {**ACCEPTED, **MOE_PROBE}
    inp = {}
    for name, (arch, _, _) in cases.items():
        inp.update(case_inputs(name, arch))
    np.savez(d / "in.npz", **inp)
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("OMP_NUM_THREADS")
    res = _wait({"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(cases)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)]}, time.time() + SPAWN_TIMEOUT_S)
    (rc, log), = res["jax"]
    assert rc == 0, log[-4000:]
    return inp, dict(np.load(d / "out.npz"))


def port_session(inp: dict, name: str, arch: str, dp: int, fsdp: bool):
    _, cfg = cfg_pair(arch)
    params = {}
    for path, _ in leaves_with_paths(tlm.param_shapes(cfg)):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = inp[f"{name}/params/" + "/".join(path)]
    return tapi.ServeSession(spec(arch, dp=dp, fsdp=fsdp),
                             tlm.params_from_jax(params, cfg, "cpu"),
                             device="cpu", cfg=cfg)


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_data_parallel_serving_gives_jaxs_sharded_tokens(jax_runs, name):
    """The port's ServeSession of the dp-2 spec (unsharded) against
    JAX's on a 2-device mesh: the prefill logits within LOGIT_RTOL and
    the generated tokens equal (the prefill's top-2 margins are wider
    than 2 LOGIT_TOL, phase 5's rule, so no token is a coin toss)."""
    inp, out = jax_runs
    arch, dp, fsdp = ACCEPTED[name]
    sess = port_session(inp, name, arch, dp, fsdp)
    prompts = inp[f"{name}/prompts"]
    logits, _ = sess.prefill(prompts)
    assert_rel(logits.numpy(), out[f"{name}/logits"], LOGIT_RTOL, name)
    top2 = logits.topk(2, dim=-1).values
    assert bool((top2[:, 0] - top2[:, 1] >= 2 * LOGIT_TOL).all())
    np.testing.assert_array_equal(sess.generate(prompts, NEW).numpy(),
                                  out[f"{name}/tokens"])


def test_jax_routes_moe_rows_per_data_shard(jax_runs):
    """Why the MoE family is refused at dp > 1: JAX's deepseek_v3 prefill
    over the same 4 prompts at dp 2 routes each shard's 2 rows with the
    capacity of its own tokens, so its logits are not its dp-1 logits."""
    _, out = jax_runs
    one, two = out["moe_dp1/logits"], out["moe_dp2/logits"]
    assert np.abs(one - two).max() > 100 * LOGIT_RTOL * np.abs(one).max()
