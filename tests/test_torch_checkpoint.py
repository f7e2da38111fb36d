"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
cases of tests/test_checkpoint.py, and the on-disk format shared with
the JAX package both ways.  A checkpoint that a JAX TrainSession wrote
loads in the port bit for bit (params, AdamW moments and step, and the
error-feedback residuals mapped to the port's (peers, total) rows); one
that the port's TrainSession wrote loads through JAX's
``load_checkpoint`` bit for bit; and the same state gives the same
manifest (leaves and hash) from either package."""
import json

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.checkpoint import ckpt as jckpt
from repro.collectives import pack_residuals as jax_pack_residuals
from repro_torch import api as tapi
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, read_manifest,
                                    read_subtree_arrays, save_checkpoint)
from repro_torch.collectives import (SyncConfig, pack_residuals,
                                     residuals_from_jax, residuals_to_jax)
from repro_torch.launch.steps import init_sync_state
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import leaves_with_paths


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tree(seed=0):
    """f32 and bf16 leaves, nested, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"layers": {"w": torch.from_numpy(
                           rng.normal(size=(8, 16)).astype(np.float32)),
                       "b": torch.zeros(16)},
            "embed": torch.from_numpy(rng.normal(size=(32, 8)).astype(
                np.float32)).to(torch.bfloat16)}


def _equal(a: dict, b: dict):
    pa, pb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# ------------------------------------------- the cases of test_checkpoint
def _roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 7, t)
    assert latest_step(tmp_path) == 7
    got, man = load_checkpoint(tmp_path, 7, {"params": t})
    _equal(got["params"], t)
    assert man["step"] == 7
    # bf16 is stored as f32 and cast back to the template's dtype
    assert man["leaves"]["params/embed"]["dtype"] == "float32"


def _corrupt_skipped(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 2, t)
    (tmp_path / "step_2" / "manifest.json").write_text("{broken")
    assert latest_step(tmp_path) == 1


def _tmp_never_counts(tmp_path):
    save_checkpoint(tmp_path, 3, _tree())
    (tmp_path / "step_9.tmp").mkdir()
    assert latest_step(tmp_path) == 3


def _manager_keeps_last_k(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps[-1] == 4 and len(steps) <= 3


def _template_checks(tmp_path):
    """A missing leaf is named; a shape that differs is another run."""
    t = _tree()
    save_checkpoint(tmp_path, 5, t)
    with pytest.raises(ValueError, match="no leaf 'params/extra'"):
        load_checkpoint(tmp_path, 5, {"params": {**t, "extra": t["embed"]}})
    wide = {**t, "embed": torch.zeros(32, 9, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="different state structure"):
        load_checkpoint(tmp_path, 5, {"params": wide})
    meta = {k: v for k, v in t.items() if k != "layers"}
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in meta.items()}
    got, _ = load_checkpoint(tmp_path, 5, {"params": meta})
    assert got["params"]["embed"].device.type == "cpu"
    assert torch.equal(got["params"]["embed"], t["embed"])


def _background_copies_first(tmp_path):
    """The writer thread reads host copies taken before it starts: a
    tensor changed in place after save() returns is saved as it was."""
    t = _tree()
    want = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in
            t.items()}
    thread = save_checkpoint(tmp_path, 4, t, background=True)
    t["embed"].add_(1.0)
    thread.join()
    got, _ = load_checkpoint(tmp_path, 4, {"params": want})
    assert torch.equal(got["params"]["embed"], want["embed"])


@pytest.mark.parametrize("case", [_roundtrip, _corrupt_skipped,
                                  _tmp_never_counts, _manager_keeps_last_k,
                                  _template_checks, _background_copies_first],
                         ids=lambda f: f.__name__.strip("_"))
def test_checkpoint_cases(case, tmp_path):
    case(tmp_path)


def test_residual_layout_mapping_and_sparse_packing():
    """(N, total) rows <-> JAX's {"rep": (N*total,), "fsdp": (0,)}, and
    the block-sparse form against JAX's pack_residuals."""
    from repro.collectives import engine as jengine
    rng = np.random.default_rng(1)
    rows = np.zeros((3, 10000), np.float32)
    rows[1, 4000:4100] = rng.normal(size=100)
    rows[2, -5:] = rng.normal(size=5)
    state = {"rep": torch.from_numpy(rows)}
    flat = residuals_to_jax(state)
    assert flat["rep"].shape == (30000,) and flat["fsdp"].shape == (0,)
    np.testing.assert_array_equal(flat["rep"].numpy(), rows.reshape(-1))
    assert torch.equal(residuals_from_jax(flat, 3)["rep"], state["rep"])
    assert residuals_to_jax({}) == {} and residuals_from_jax({}, 3) == {}
    with pytest.raises(ValueError, match="FSDP"):
        residuals_from_jax({"rep": flat["rep"], "fsdp": torch.ones(2)}, 3)
    with pytest.raises(ValueError, match="split over 7 peers"):
        residuals_from_jax(flat, 7)
    packed = pack_residuals(flat)
    want = jengine.pack_residuals({k: v.numpy() for k, v in flat.items()})
    for name in want:
        for k in ("idx", "val", "shape"):
            np.testing.assert_array_equal(packed[name][k], want[name][k])
    assert packed["rep"]["idx"].tolist() == [3, 7]   # 14000.. and 29995..


# ------------------------------------------------ across the two packages
def _spec_kw(direc):
    return dict(arch="minitron_4b", smoke=True, steps=2,
                optim=dict(lr=1e-3),
                data=dict(vocab=0, seq_len=32, global_batch=2, seed=0),
                sync=dict(mode="optinc", bits=8, block=256,
                          error_feedback=True),
                ckpt=dict(dir=str(direc), every=1))


def _jax_spec(direc):
    kw = _spec_kw(direc)
    return japi.RunSpec(
        **{k: v for k, v in kw.items()
           if k not in ("optim", "data", "sync", "ckpt")},
        optim=japi.AdamWConfig(**kw["optim"]),
        data=japi.DataConfig(**kw["data"]),
        sync=japi.SyncConfig(**kw["sync"]),
        ckpt=japi.CheckpointConfig(**kw["ckpt"]))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX TrainSession (minitron smoke, bf16, error feedback, one
    device) after 2 steps, with its checkpoint of step 1."""
    direc = tmp_path_factory.mktemp("jax_ckpt")
    sess = japi.TrainSession(_jax_spec(direc),
                             callbacks=[japi.PeriodicCheckpoint(1)])
    sess.run()
    state = {"params": sess.params, "opt": sess.opt_state,
             "sync": sess.sync_state}
    return direc, jax.tree.map(np.asarray, state)


def _np(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, bf16 through its bits."""
    if x.dtype == torch.bfloat16:
        import ml_dtypes
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def _port_template(cfg, peers):
    """The port's state structure, as TrainSession builds it."""
    params = tlm.init_params(cfg, 0, "cpu")
    sync = init_sync_state(cfg, peers, SyncConfig(error_feedback=True), "cpu")
    return {"params": params, "opt": adamw_init(AdamWConfig(), params),
            "sync": residuals_to_jax(sync)}


def test_jax_checkpoint_loads_in_the_port_bit_for_bit(jax_run):
    direc, want = jax_run
    assert latest_step(direc) == 1
    cfg = tapi.RunSpec(arch="minitron_4b", smoke=True).model_config()
    tree, man = load_checkpoint(direc, 1, _port_template(cfg, 1))
    assert man["extra"]["arch"] == cfg.name
    # the JAX run_spec parses in the port and is its own spec
    spec = tapi.RunSpec.from_json_dict(man["extra"]["run_spec"])
    assert json.loads(spec.to_json()) == man["extra"]["run_spec"]
    assert tree["params"]["embed"].dtype == torch.bfloat16
    for (path, got), (_, ref) in zip(leaves_with_paths(tree),
                                     leaves_with_paths(want)):
        np.testing.assert_array_equal(_np(got), ref, err_msg=str(path))
    rows = residuals_from_jax(tree["sync"], 1)["rep"]
    assert rows.shape == (1, want["sync"]["rep"].size)
    assert np.abs(rows.numpy()).max() > 0       # a real carry
    assert int(tree["opt"]["step"]) == 2


def test_port_checkpoint_loads_through_jax_bit_for_bit(jax_run, tmp_path):
    """A port TrainSession (the same spec, 2 stacked peers) writes steps 0
    and 1; JAX's load_checkpoint restores step 1 into a JAX template of
    2 devices' state, bit for bit, and its run_spec parses in JAX."""
    _, jstate = jax_run
    spec = tapi.RunSpec.from_json_dict({**_spec_kw(tmp_path),
                                        "mesh": {"dp": 2}})
    sess = tapi.TrainSession(spec, callbacks=[tapi.PeriodicCheckpoint(1)],
                             device="cpu")
    sess.run()
    man = read_manifest(tmp_path, 1)
    japi.RunSpec.from_json_dict(man["extra"]["run_spec"]).validate()
    n = jstate["sync"]["rep"].size
    template = jax.tree.map(lambda a: a, jstate)
    template["sync"] = {"rep": np.zeros((2 * n,), np.float32),
                        "fsdp": np.zeros((0,), np.float32)}
    got, _ = jckpt.load_checkpoint(tmp_path, 1, template)
    port = {"params": sess.params, "opt": sess.opt_state,
            "sync": residuals_to_jax(sess.sync_state)}
    for (path, ref), g in zip(leaves_with_paths(port),
                              jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), _np(ref),
                                      err_msg=str(path))


def test_same_state_gives_the_same_manifest(jax_run, tmp_path):
    """The JAX state saved by JAX and carried to the port and saved
    there: the same leaves and the same hash; the block-sparse sync
    subtree too, and read back by both subtree readers alike."""
    _, st = jax_run
    cfg = tapi.RunSpec(arch="minitron_4b", smoke=True).model_config()
    carried = {
        "params": tlm.params_from_jax(st["params"], cfg, device="cpu"),
        "opt": jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                            st["opt"]),
        "sync": residuals_to_jax(residuals_from_jax(
            {k: torch.from_numpy(np.array(v)) for k, v in st["sync"].items()},
            1))}
    for sparse in (False, True):
        jsync = jax_pack_residuals(st["sync"]) if sparse else st["sync"]
        tsync = (pack_residuals(carried["sync"]) if sparse
                 else carried["sync"])
        jckpt.save_checkpoint(tmp_path / "jax", 3, st["params"], st["opt"],
                              jsync, extra={"k": 1})
        save_checkpoint(tmp_path / "port", 3, carried["params"],
                        carried["opt"], tsync, extra={"k": 1})
        jm = json.loads((tmp_path / "jax" / "step_3" /
                         "manifest.json").read_text())
        tm = read_manifest(tmp_path / "port", 3)
        assert tm == jm
        assert list(tm["leaves"]) == list(jm["leaves"])
        a = read_subtree_arrays(tmp_path / "port", 3, "sync")
        b = jckpt.read_subtree_arrays(tmp_path / "jax", 3, "sync")
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ["phi35_moe_42b", "deepseek_v3_671b"])
def test_moe_checkpoints_cross_the_packages(arch, tmp_path):
    """The MoE family's trees (moe_layers with their one norm, and for
    deepseek MLA's q_norm/kv_norm, dense_layers and mtp): a JAX
    TrainSession's checkpoint of the SMOKE config loads in the port bit
    for bit; the port's TrainSession of the same spec writes one that
    JAX's load_checkpoint restores bit for bit; and JAX's state saved by
    either package gives the same manifest, hash included."""
    kw = {**_spec_kw(tmp_path / "jax"), "arch": arch, "steps": 1}
    jspec = japi.RunSpec(
        **{k: v for k, v in kw.items()
           if k not in ("optim", "data", "sync", "ckpt")},
        optim=japi.AdamWConfig(**kw["optim"]),
        data=japi.DataConfig(**kw["data"]),
        sync=japi.SyncConfig(**kw["sync"]),
        ckpt=japi.CheckpointConfig(**kw["ckpt"]))
    jsess = japi.TrainSession(jspec, callbacks=[japi.PeriodicCheckpoint(1)])
    jsess.run()
    want = jax.tree.map(np.asarray, {"params": jsess.params,
                                     "opt": jsess.opt_state,
                                     "sync": jsess.sync_state})
    cfg = tapi.RunSpec(arch=arch, smoke=True).model_config()
    tree, man = load_checkpoint(tmp_path / "jax", 0, _port_template(cfg, 1))
    assert man["extra"]["arch"] == cfg.name
    assert set(tree["params"]) >= {"moe_layers"} | (
        {"dense_layers", "mtp"} if cfg.mla else set())
    for (path, got), (_, ref) in zip(leaves_with_paths(tree),
                                     leaves_with_paths(want)):
        np.testing.assert_array_equal(_np(got), ref, err_msg=str(path))
    # the port's session of the same spec, read back through JAX
    pdir = tmp_path / "port"
    spec = tapi.RunSpec.from_json_dict({**_spec_kw(pdir), "arch": arch,
                                        "steps": 1})
    sess = tapi.TrainSession(spec, callbacks=[tapi.PeriodicCheckpoint(1)],
                             device="cpu")
    sess.run()
    got, _ = jckpt.load_checkpoint(pdir, 0, want)
    port = {"params": sess.params, "opt": sess.opt_state,
            "sync": residuals_to_jax(sess.sync_state)}
    for (path, ref), g in zip(leaves_with_paths(port), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), _np(ref),
                                      err_msg=str(path))
    # JAX's state saved by each package: the same manifest
    carried = {"params": tlm.params_from_jax(want["params"], cfg,
                                             device="cpu"),
               "opt": jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                   want["opt"])}
    jckpt.save_checkpoint(tmp_path / "j2", 3, want["params"], want["opt"],
                          extra={"k": 1})
    save_checkpoint(tmp_path / "p2", 3, carried["params"], carried["opt"],
                    extra={"k": 1})
    jm = json.loads((tmp_path / "j2" / "step_3" / "manifest.json").read_text())
    assert read_manifest(tmp_path / "p2", 3) == jm
