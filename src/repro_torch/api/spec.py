"""Declarative run description (counterpart of ``repro.api.spec``).

A ``RunSpec`` is a frozen, JSON-serializable description of ONE scenario
(model x peers x sync backend x optimizer x data x checkpointing x
serving).  ``launch/train.py`` builds one from its flags (or a JSON file)
and hands it to ``TrainSession``; ``ServeSession`` serves one.

Its JSON keys are the JAX package's, so a JAX checkpoint's
``extra.run_spec`` parses here and one written here parses in JAX.
Fields the port does not run yet are taken when they hold their
defaults and refused by name otherwise (``validate``).

``MeshSpec`` keeps JAX's fields: ``pods * dp`` data-parallel peers
(stacked on one device, or processes), each ``tp`` ranks of the 'model'
axis, with FSDP and remat groups; ``ctx()`` is the model code's
ShardCtx.  ``build()`` (a jax Mesh) has no torch meaning: a sharded run
is a mesh of processes (``launch.distributed``), one a device, and
tensor parallelism exists only there (``check_launch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

from ..collectives.engine import SyncConfig
from ..data.pipeline import DataConfig
from ..elastic.config import ElasticConfig
from ..launch.mesh import sync_axes
from ..models.layers import ShardCtx
from ..optim.adamw import AdamWConfig
from ..photonics.config import FIDELITIES, MESH_BACKENDS
from ..serving.config import ServeConfig

# the JAX package's sync backends
SYNC_MODES = ("cascade", "optinc", "psum", "ring")


# why sequence parallelism stays refused (a CPU probe of the reference,
# llama3_405b SMOKE in f32 at mesh (1, 2))
_SP_DEFECT = (": the reference's swiglu_mlp takes the sequence-sharded "
              "residual and ends with a psum over 'model', so it adds the "
              "outputs of different sequence positions (its loss at mesh "
              "1x2 is 5.583917 with it, 5.571617 without)")


class SpecError(ValueError):
    """A RunSpec is malformed, internally inconsistent, or asks for what
    the port does not run yet."""


class SpecMismatchError(SpecError):
    """--resume found a checkpoint written by an incompatible RunSpec."""


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The JAX device-mesh description: ``pods * dp`` data-parallel
    peers (``pods`` is the cascade's level-2 axis), each ``tp`` devices
    of the 'model' axis; ``fsdp`` shards the weights over 'data';
    ``remat_groups`` is JAX's two-level remat.  ``seq_parallel`` is
    refused (``RunSpec.validate``)."""
    dp: int = 1
    tp: int = 1
    pods: int = 1
    fsdp: bool = False
    seq_parallel: bool = False
    remat_groups: int = 0

    def __post_init__(self):
        if min(self.dp, self.tp, self.pods) < 1:
            raise SpecError(f"mesh sizes must be >= 1: {self}")
        if self.remat_groups < 0:
            raise SpecError(f"remat_groups must be >= 0: {self}")

    @property
    def shape(self) -> tuple:
        return ((self.pods, self.dp, self.tp) if self.pods > 1
                else (self.dp, self.tp))

    @property
    def peers(self) -> int:
        """The data-parallel peers, pods * dp."""
        return self.pods * self.dp

    @property
    def devices(self) -> int:
        """The devices of the mesh (processes of a launched run), pods *
        dp * tp."""
        return self.pods * self.dp * self.tp

    def ctx(self, *, seq_shard_cache: bool = False) -> ShardCtx:
        """The ShardCtx of this mesh (JAX's ``MeshSpec.ctx``)."""
        return ShardCtx(tp=self.tp, dp=self.dp, pods=self.pods,
                        fsdp=self.fsdp, seq_shard_cache=seq_shard_cache,
                        seq_parallel=self.seq_parallel,
                        remat_groups=self.remat_groups)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    dir: str = ""          # "" = checkpointing off
    every: int = 50        # save every N steps (and on stop / final step)
    keep: int = 3          # retained checkpoints
    resume: bool = False   # restart from the newest valid checkpoint


def _from_dict(cls, d):
    """Rebuild a (possibly nested) frozen config dataclass from JSON data,
    coercing lists back to tuples and rejecting unknown keys loudly."""
    if not isinstance(d, dict):
        raise SpecError(f"{cls.__name__} must be a JSON object, got {d!r}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - set(fields))
    if unknown:
        raise SpecError(f"unknown {cls.__name__} key(s): {unknown} "
                        f"(known: {sorted(fields)})")
    kw = {}
    for name, val in d.items():
        default = fields[name].default
        if dataclasses.is_dataclass(default) and isinstance(val, dict):
            val = _from_dict(type(default), val)
        elif isinstance(default, tuple) and isinstance(val, list):
            val = tuple(val)
        kw[name] = val
    try:
        return cls(**kw)
    except (TypeError, ValueError) as e:
        # config dataclasses validate in __post_init__ (an unknown
        # fidelity or sync mode, a Table-II key): spec errors too
        raise SpecError(f"invalid {cls.__name__}: {e}")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One fully-specified scenario. Frozen + JSON round-trippable."""
    arch: str = "paper_llama"
    smoke: bool = False                 # use the arch's reduced SMOKE config
    mesh: MeshSpec = MeshSpec()
    sync: SyncConfig = SyncConfig()
    optim: AdamWConfig = AdamWConfig()
    # vocab 0 = the model's vocab; --seed feeds both seeds
    data: DataConfig = DataConfig(vocab=0, seed=0)
    ckpt: CheckpointConfig = CheckpointConfig()
    serve: ServeConfig = ServeConfig()
    elastic: ElasticConfig = ElasticConfig()
    steps: int = 100
    seed: int = 0
    watchdog: float = 3.0               # straggler threshold (x median)
    log: str = ""                       # JSONL metrics file ("" = stdout only)

    # ------------------------------------------------ resolution helpers
    def model_config(self):
        from .. import configs
        try:
            return (configs.get_smoke(self.arch) if self.smoke
                    else configs.get(self.arch))
        except ValueError as e:
            raise SpecError(str(e))

    def resolved_data(self, cfg=None) -> DataConfig:
        if self.data.vocab:
            return self.data
        cfg = cfg if cfg is not None else self.model_config()
        return dataclasses.replace(self.data, vocab=cfg.vocab)

    def resolved_sync(self) -> SyncConfig:
        """Sync axes canonicalized to the mesh's DP axes."""
        return dataclasses.replace(self.sync,
                                   axes=sync_axes(self.mesh.pods))

    def _refuse_unported(self) -> None:
        """Name each field the port does not run yet, and the slice that
        brings it."""
        m, e = self.mesh, self.elastic
        for bad, what in (
                (m.seq_parallel, "mesh.seq_parallel (--seq-parallel): "
                                 "sequence parallelism"),
                (e.enabled, "elastic.enabled (--elastic): elastic "
                            "membership (the elastic slice)"),
                ((e.dir, e.heartbeat_s, e.timeout_s) != ("", 1.0, 0.0),
                 "elastic.dir/heartbeat_s/timeout_s (--members-dir, "
                 "--heartbeat-s): elastic membership (the elastic slice)"),
                (e.evict_after > 0, "elastic.evict_after (--evict-after): "
                                    "the watchdog's escalation to elastic "
                                    "membership (the elastic slice)"),
                (self.optim.moment_dtype != "float32",
                 f"optim.moment_dtype={self.optim.moment_dtype!r}: bf16 "
                 f"AdamW moments")):
            if bad:
                raise SpecError(f"{what} is not ported yet" + (
                    _SP_DEFECT if what.startswith("mesh.seq") else ""))

    def validate(self) -> "RunSpec":
        self.model_config()
        self._refuse_unported()
        if self.steps < 1:
            raise SpecError(f"steps must be >= 1, got {self.steps}")
        if (self.sync.mode == "cascade" and self.mesh.pods < 2
                and not (self.elastic.enabled or self.elastic.allow_reshard)):
            # a resharded resume may shrink a cascade to one pod (it
            # degrades to its one-level form), so the two-pod floor only
            # binds static topologies
            raise SpecError("--sync cascade needs a level-2 'pod' axis "
                            "(mesh.pods >= 2, e.g. --pods 2)")
        ph = self.sync.photonics
        if (ph.fidelity != "behavioral" and self.sync.mode == "cascade"
                and self.sync.bits > 2):
            raise SpecError(
                f"the photonic cascade carries the eq.-10 decimal part on "
                f"the least-significant unit-P group, which is only on the "
                f"ONN's grid for bits <= 2; got --bits {self.sync.bits} "
                f"with --sync cascade --fidelity {ph.fidelity} (use "
                f"--fidelity behavioral for wider widths)")
        if ph.mesh_backend != "xla" and ph.fidelity != "mesh":
            raise SpecError(
                f"--mesh-backend {ph.mesh_backend} selects the MZI-emulator "
                f"executor and only applies to --fidelity mesh; got "
                f"--fidelity {ph.fidelity}")
        if ph.blk_b != 0 and ph.fidelity != "mesh":
            raise SpecError(
                f"--blk-b tiles the MZI-emulator kernel's rows and only "
                f"applies to --fidelity mesh; got --fidelity {ph.fidelity}")
        if self.sync.overlap and (self.mesh.fsdp or self.mesh.tp > 1):
            raise SpecError(
                "--overlap streams the replicated-leaf buckets of one "
                "gradient stack and is not ported together with --fsdp or "
                "tp > 1 (--mesh DPxTP)")
        if self.sync.sparse_residuals and not self.sync.error_feedback:
            raise SpecError("--sparse-residuals compresses the checkpointed "
                            "error-feedback residuals and needs "
                            "--error-feedback")
        dp_total = self.mesh.pods * self.mesh.dp
        if self.data.global_batch % dp_total:
            raise SpecError(f"global_batch {self.data.global_batch} not "
                            f"divisible by pods*dp = {dp_total}")
        if self.ckpt.resume and not self.ckpt.dir:
            raise SpecError("ckpt.resume requires ckpt.dir")
        if self.serve.max_seq < self.serve.page_size:
            raise SpecError(f"serve.max_seq ({self.serve.max_seq}) must be "
                            f">= serve.page_size ({self.serve.page_size})")
        if self.serve.top_k and self.serve.temperature == 0:
            raise SpecError("--top-k samples from the softmax and needs "
                            "--temperature > 0 (temperature 0 = greedy)")
        if self.serve.reload_every and not self.ckpt.dir:
            raise SpecError("--reload-every polls the checkpoint directory "
                            "and needs --ckpt-dir")
        return self

    def check_launch(self, launched: bool, world_size: int = 0) -> None:
        """Raise unless the run's processes fit the mesh: a launched run
        (``launch.distributed.launched``) must be pods * dp * tp
        processes, one a device; tensor parallelism exists only across
        processes."""
        m = self.mesh
        if launched and world_size != m.devices:
            raise SpecError(
                f"WORLD_SIZE {world_size} != mesh.peers {m.peers} x mesh.tp "
                f"{m.tp} = {m.devices} (pods {m.pods} x dp {m.dp} x tp "
                f"{m.tp}): a launched run is one process a device")
        if not launched and m.tp > 1:
            raise SpecError(
                f"mesh.tp={m.tp} (--mesh {m.dp}x{m.tp}): tensor parallelism "
                f"runs as one process a device; launch {m.devices} "
                f"processes with python -m torch.distributed.run "
                f"--nproc-per-node {m.devices}")

    def check_trains(self, cfg=None) -> None:
        """Raise for an encoder-decoder arch: the training entry points
        (``TrainSession``, the train CLI) feed tokens only, as JAX's do.
        Serving takes it (``ServeSession.generate(..., enc_frames=)``)."""
        cfg = cfg if cfg is not None else self.model_config()
        if cfg.enc_dec:
            raise SpecError(
                f"arch {self.arch!r} is an encoder-decoder model: JAX's "
                f"trainer (TrainSession, the train CLI) feeds tokens only "
                f"and no enc_frames, so neither package's session trains it; "
                f"its entry point is repro_torch.launch.steps.make_train_step"
                f" with a batch that carries enc_frames")

    def check_serves(self, cfg=None) -> None:
        """Raise for a mesh that serving would not run as JAX shards it
        (the port serves in one process, unsharded): tp > 1 (JAX splits
        the heads and the vocabulary over 'model', with bf16 psums), the
        MoE family at pods * dp > 1 (JAX routes each data shard's rows
        with the capacity of that shard's token count) and the enc-dec
        family with FSDP at pods * dp > 1 (JAX projects the encoder
        output with the un-gathered shard of x_wk/x_wv).  Dense and
        recurrent rows are computed as JAX's data shards compute them, so
        dp > 1 and FSDP (an exact all-gather of the weights) are taken."""
        cfg = cfg if cfg is not None else self.model_config()
        m = self.mesh
        what = ("is not ported to serving (one process, unsharded; the "
                "sharded-serving slice brings it)")
        if m.tp > 1:
            raise SpecError(
                f"mesh.tp={m.tp} (--mesh {m.dp}x{m.tp}): tensor-parallel "
                f"serving {what}")
        if cfg.moe and m.peers > 1:
            raise SpecError(
                f"mesh.pods * mesh.dp = {m.peers} with {cfg.name}: MoE "
                f"serving over data shards, each routing its own rows "
                f"with the capacity of its own token count, {what}")
        if cfg.enc_dec and m.fsdp and m.peers > 1:
            raise SpecError(
                f"mesh.fsdp (--fsdp) at mesh.pods * mesh.dp = {m.peers} "
                f"with {cfg.name}: the reference projects the encoder "
                f"output with the un-gathered FSDP shard of x_wk/x_wv, "
                f"and the port refuses it as its trainer does")

    # ------------------------------------------------ JSON round-trip
    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_json_dict(), indent=indent)

    @classmethod
    def from_json_dict(cls, d: dict) -> "RunSpec":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        return cls.from_json_dict(json.loads(text))

    def save(self, path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "RunSpec":
        try:
            text = pathlib.Path(path).read_text()
        except OSError as e:
            raise SpecError(f"cannot read spec file {path}: {e}")
        try:
            return cls.from_json(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"spec file {path} is not valid JSON: {e}")

    # ------------------------------------------------ resume compatibility
    def state_fingerprint(self) -> dict:
        """The spec fields that determine checkpoint state CONTENT (the
        shapes and meaning of the saved arrays): they must match across
        any resume."""
        return {"arch": self.arch, "smoke": self.smoke,
                "moment_dtype": self.optim.moment_dtype,
                "error_feedback": self.sync.error_feedback}

    def shape_fingerprint(self) -> dict:
        """The spec fields that determine only the state's placement:
        the mesh (the residuals' rows and sizes, the shards)."""
        return {"mesh": dataclasses.asdict(self.mesh)}

    def compat_fingerprint(self) -> dict:
        return {**self.state_fingerprint(), **self.shape_fingerprint()}

    # ------------------------------------------------ CLI surface
    @staticmethod
    def add_args(ap: argparse.ArgumentParser) -> None:
        """The JAX train-style CLI (every JAX flag; ``validate`` refuses
        what the port does not run) plus ``--block``, the port's flag for
        ``sync.block``.  Absent flags leave the base spec untouched."""
        ap.add_argument("--spec", help="RunSpec JSON file (flags override)")
        ap.add_argument("--arch", help="architecture id (repro_torch.configs)")
        ap.add_argument("--smoke-config", action="store_true",
                        help="use the arch's reduced SMOKE config")
        ap.add_argument("--sync", choices=SYNC_MODES,
                        help="gradient-sync backend")
        ap.add_argument("--bucket-mb", type=float,
                        help="fused gradient-bucket size in MiB")
        ap.add_argument("--block", type=int,
                        help="quantization block (0 = one scale a bucket)")
        ap.add_argument("--pods", type=int,
                        help="pod (level-2) axis size (0 = auto: 2 for "
                             "--sync cascade, else 1)")
        ap.add_argument("--bits", type=int, help="OptINC bit width B")
        ap.add_argument("--overlap", action="store_true",
                        help="stream gradient buckets in readiness order "
                             "so the sync overlaps the rest of the "
                             "backward (bit-exact vs off)")
        ap.add_argument("--fidelity", choices=FIDELITIES,
                        help="optinc emulation depth: behavioral Q(mean) | "
                             "trained dense ONN | MZI mesh emulator")
        ap.add_argument("--mesh-backend", choices=MESH_BACKENDS,
                        help="fidelity=mesh executor; both run the "
                             "mesh_scan kernel in the port")
        ap.add_argument("--blk-b", type=int,
                        help="mesh_scan kernel row tile (multiple of 8; 0 "
                             "= default)")
        ap.add_argument("--theta-drift-std", type=float,
                        help="PhaseNoise: thermal drift std (rad) on every "
                             "programmed MZI phase (fidelity=mesh)")
        ap.add_argument("--shot-noise-std", type=float,
                        help="PhaseNoise: additive noise std on the mesh's "
                             "analog outputs (fidelity=mesh)")
        ap.add_argument("--error-layers",
                        help="Table II key, e.g. '3,4,5,6': inject the "
                             "ONN's errors into the averaged codes")
        ap.add_argument("--error-feedback", action="store_true")
        ap.add_argument("--sparse-residuals", action="store_true",
                        help="checkpoint error-feedback residuals "
                             "block-sparsely (only blocks with nonzero "
                             "carry)")
        ap.add_argument("--fsdp", action="store_true",
                        help="shard params over the data axis (ZeRO-3)")
        ap.add_argument("--seq-parallel", action="store_true",
                        help="refused: the reference's MLP mixes sequence "
                             "shards")
        ap.add_argument("--remat-groups", type=int,
                        help="two-level remat: checkpoint groups of "
                             "layers (0 = off)")
        ap.add_argument("--steps", type=int)
        ap.add_argument("--global-batch", type=int)
        ap.add_argument("--seq-len", type=int)
        ap.add_argument("--lr", type=float)
        ap.add_argument("--mesh", help="DPxTP, e.g. 4x1 or 2x2: DP "
                                       "data-parallel peers, TP model "
                                       "shards each (TP > 1: one process "
                                       "a device)")
        ap.add_argument("--ckpt-dir")
        ap.add_argument("--ckpt-every", type=int)
        ap.add_argument("--ckpt-keep", type=int)
        ap.add_argument("--resume", action="store_true")
        ap.add_argument("--elastic", action="store_true", help="not ported")
        ap.add_argument("--heartbeat-s", type=float, help="elastic")
        ap.add_argument("--allow-reshard", action="store_true",
                        help="permit --resume onto a different peer count "
                             "(params and optimizer reloaded, "
                             "error-feedback residuals re-zeroed)")
        ap.add_argument("--members-dir", help="elastic")
        ap.add_argument("--evict-after", type=int, help="elastic")
        ap.add_argument("--watchdog", type=float,
                        help="straggler threshold (x the rolling median "
                             "step time; 0 = off)")
        ap.add_argument("--seed", type=int)
        ap.add_argument("--log", help="JSONL metrics file")
        ap.add_argument("--page-size", type=int,
                        help="serving: tokens per paged-KV page")
        ap.add_argument("--max-active", type=int,
                        help="serving: concurrently decoding sequences")
        ap.add_argument("--max-queue", type=int,
                        help="serving: queued-request cap")
        ap.add_argument("--max-seq", type=int,
                        help="serving: per-sequence cache capacity")
        ap.add_argument("--max-new-tokens", type=int,
                        help="serving: default per-request generation budget")
        ap.add_argument("--stop-token", type=int,
                        help="serving: end-of-sequence token id (-1 = none)")
        ap.add_argument("--temperature", type=float,
                        help="serving: sampling temperature (0 = greedy)")
        ap.add_argument("--top-k", type=int,
                        help="serving: sample from the k best logits")
        ap.add_argument("--serve-pages", type=int,
                        help="serving: physical KV pool size in pages "
                             "(0 = auto)")
        ap.add_argument("--reload-every", type=int,
                        help="serving: poll --ckpt-dir for newer params "
                             "every N engine steps (hot-swap; 0 = off)")
        ap.add_argument("--decode-backend", choices=("gather", "paged"),
                        help="serving: JAX's decode path; both run the "
                             "paged kernel in the port")
        ap.add_argument("--kv-dtype", choices=("auto", "f32", "bf16"),
                        help="serving: KV pool storage dtype")

    @classmethod
    def from_args(cls, argv=None, description: str | None = None) -> "RunSpec":
        ap = argparse.ArgumentParser(
            description=description, argument_default=argparse.SUPPRESS,
            formatter_class=argparse.RawDescriptionHelpFormatter)
        cls.add_args(ap)
        return cls.from_cli_dict(vars(ap.parse_args(argv)))

    @classmethod
    def from_cli_dict(cls, ns: dict) -> "RunSpec":
        """The validated spec of parsed (present-only) flags: the --spec
        file or the defaults, with the other flags laid over it."""
        ns = dict(ns)
        base = cls.load(ns.pop("spec")) if "spec" in ns else cls()
        return base.apply_cli(ns).validate()

    def apply_cli(self, ns: dict) -> "RunSpec":
        """Overlay a dict of (present-only) CLI args onto this spec."""
        ns = dict(ns)
        mesh_kw, sync_kw, opt_kw = {}, {}, {}
        data_kw, ckpt_kw, top_kw = {}, {}, {}
        if "arch" in ns:
            top_kw["arch"] = ns.pop("arch")
        if "smoke_config" in ns:
            top_kw["smoke"] = ns.pop("smoke_config")
        if "mesh" in ns:
            raw = ns.pop("mesh")
            try:
                mesh_kw["dp"], mesh_kw["tp"] = (int(x) for x in raw.split("x"))
            except ValueError:
                raise SpecError(f"--mesh must be DPxTP (e.g. 4x1): {raw!r}")
        pods = ns.pop("pods", None)
        for k in ("fsdp", "seq_parallel", "remat_groups"):
            if k in ns:
                mesh_kw[k] = ns.pop(k)
        for k, field in (("sync", "mode"), ("bits", "bits"),
                         ("block", "block"), ("overlap", "overlap"),
                         ("error_feedback", "error_feedback"),
                         ("sparse_residuals", "sparse_residuals")):
            if k in ns:
                sync_kw[field] = ns.pop(k)
        ph_kw = {k: ns.pop(k) for k in ("fidelity", "mesh_backend", "blk_b",
                                        "theta_drift_std", "shot_noise_std")
                 if k in ns}
        if "bucket_mb" in ns:
            sync_kw["bucket_bytes"] = int(ns.pop("bucket_mb") * 2 ** 20)
        if "error_layers" in ns:
            raw = ns.pop("error_layers")
            sync_kw["error_layers"] = (tuple(int(x) for x in raw.split(","))
                                       if raw else ())
        if "lr" in ns:
            opt_kw["lr"] = ns.pop("lr")
        if "seq_len" in ns:
            data_kw["seq_len"] = ns.pop("seq_len")
        if "global_batch" in ns:
            data_kw["global_batch"] = ns.pop("global_batch")
        if "seed" in ns:
            top_kw["seed"] = data_kw["seed"] = ns.pop("seed")
        for k, field in (("ckpt_dir", "dir"), ("ckpt_every", "every"),
                         ("ckpt_keep", "keep"), ("resume", "resume")):
            if k in ns:
                ckpt_kw[field] = ns.pop(k)
        serve_kw = {k: ns.pop(k) for k in (
            "page_size", "max_active", "max_queue", "max_seq",
            "max_new_tokens", "stop_token", "temperature", "top_k",
            "reload_every", "decode_backend", "kv_dtype") if k in ns}
        if "serve_pages" in ns:
            serve_kw["pages"] = ns.pop("serve_pages")
        elastic_kw = {}
        for k, field in (("elastic", "enabled"), ("heartbeat_s", "heartbeat_s"),
                         ("allow_reshard", "allow_reshard"),
                         ("members_dir", "dir"),
                         ("evict_after", "evict_after")):
            if k in ns:
                elastic_kw[field] = ns.pop(k)
        for k in ("steps", "watchdog", "log"):
            if k in ns:
                top_kw[k] = ns.pop(k)
        if ns:
            raise SpecError(f"unhandled CLI key(s): {sorted(ns)}")
        mode = sync_kw.get("mode", self.sync.mode)
        if pods is not None and pods > 0:
            mesh_kw["pods"] = pods
        elif mode == "cascade" and mesh_kw.get("pods", self.mesh.pods) < 2:
            mesh_kw["pods"] = 2     # absent or 0: cascade needs its pod axis
        try:
            if ph_kw:
                sync_kw["photonics"] = dataclasses.replace(
                    self.sync.photonics, **ph_kw)
            return dataclasses.replace(
                self,
                mesh=dataclasses.replace(self.mesh, **mesh_kw),
                sync=dataclasses.replace(self.sync, **sync_kw),
                optim=dataclasses.replace(self.optim, **opt_kw),
                data=dataclasses.replace(self.data, **data_kw),
                ckpt=dataclasses.replace(self.ckpt, **ckpt_kw),
                serve=dataclasses.replace(self.serve, **serve_kw),
                elastic=dataclasses.replace(self.elastic, **elastic_kw),
                **top_kw)
        except SpecError:
            raise
        except ValueError as e:
            # a config dataclass refused a value in __post_init__
            raise SpecError(str(e))


@dataclasses.dataclass(frozen=True)
class ResumeCompat:
    """Structured verdict of a checkpoint-vs-run spec comparison.

    ``verdict``:
      * ``"exact"``        — fingerprints identical; bit-exact restore.
      * ``"reshardable"``  — state fields match, only ``mesh`` differs
        (in the port: the peer count); restorable with params and the
        optimizer reloaded and the residuals re-zeroed.
      * ``"incompatible"`` — state fields differ; the saved arrays do
        not describe this run's state.
    """
    verdict: str                      # exact | reshardable | incompatible
    state_diff: tuple = ()            # differing state_fingerprint keys
    shape_diff: tuple = ()            # differing shape_fingerprint keys
    detail: str = ""                  # human-readable field-by-field diff

    @property
    def ok(self) -> bool:
        return self.verdict != "incompatible"


def _diff(a: dict, b: dict) -> tuple:
    return tuple(k for k in b if a.get(k) != b[k])


def check_resume_compat(saved: RunSpec, current: RunSpec) -> ResumeCompat:
    """Pure comparison; never raises (``validate_resume_compat``
    enforces)."""
    state = _diff(saved.state_fingerprint(), current.state_fingerprint())
    shape = _diff(saved.shape_fingerprint(), current.shape_fingerprint())
    sa, sb = saved.compat_fingerprint(), current.compat_fingerprint()
    detail = "; ".join(f"{k}: checkpoint={sa.get(k)!r} vs run={sb[k]!r}"
                       for k in state + shape)
    verdict = ("incompatible" if state
               else "reshardable" if shape else "exact")
    return ResumeCompat(verdict=verdict, state_diff=state, shape_diff=shape,
                        detail=detail)


def validate_resume_compat(saved: RunSpec, current: RunSpec,
                           allow_reshard: bool = False) -> ResumeCompat:
    """Enforce resume compatibility and return the verdict:
    ``incompatible`` always raises SpecMismatchError, ``reshardable``
    raises unless ``allow_reshard`` (``--allow-reshard``)."""
    compat = check_resume_compat(saved, current)
    if compat.verdict == "incompatible":
        raise SpecMismatchError(
            f"checkpoint was written by an incompatible RunSpec "
            f"({compat.detail}). Start a fresh run (drop --resume / change "
            f"--ckpt-dir) or match the checkpointed spec.")
    if compat.verdict == "reshardable" and not allow_reshard:
        raise SpecMismatchError(
            f"checkpoint was written on a different mesh shape "
            f"({compat.detail}). Pass --allow-reshard to resume via the "
            f"compatible-reshard path (global state re-placed onto the new "
            f"mesh; error-feedback residuals re-bucketized), or match the "
            f"checkpointed mesh.")
    return compat
