"""What phase 4i (b)'s two checks of ``chip_smoke.py`` read when the
tensor-parallel model is wrong.

Two copies of ``src/`` and ``chip_smoke.py`` are made under DIR: one as
it is, one with the 'model' psum at the end of
``repro_torch.models.layers.swiglu_mlp`` removed (a row-parallel MLP
whose shards never meet).  In each, (b)'s readings are taken on the CPU
(gloo ranks, paper_llama's smoke config in bf16, 8 sequences of 64):
the step-0 loss of ``--mesh 2x2`` on 4 ranks against the stacked dp-2
run (limit ``chip_smoke.TP_LOSS_TOL``), and the model-sharded leaves'
step-0 gradients against 2 x the tp-1 ones (``check_tp_grads``, limit
``TP_GRAD_RTOL``).  The repo itself is never changed.

    python scripts/tp_planted_fault.py DIR
"""
from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU_ARGV = ('["--arch", "paper_llama", "--smoke-config", "--sync", '
            '"optinc", "--bits", "8", "--block", "2048", "--mesh", "4x1", '
            '"--global-batch", "8", "--seq-len", "64", "--device", "cpu"]')
PSUM = "    return psum_model(h @ gather_fsdp(ctx, axes, w_down, 1), axes)\n"
NO_PSUM = "    return h @ gather_fsdp(ctx, axes, w_down, 1)\n"
READ = """
import chip_smoke as c
_, stacked = c.train_run(["--mesh", "2x1"], 1)
_, report, _ = c.process_run(4, ["--mesh", "2x2"], 1)
print(f"step-0 loss at tp 2 {report['losses'][0]} vs the stacked dp 2 "
      f"run's {stacked[0]}: |diff| {abs(report['losses'][0] - stacked[0]):.3e}"
      f" (limit {c.TP_LOSS_TOL})", flush=True)
try:
    c.check_tp_grads("cpu")
except AssertionError as e:
    print(f"the gradient check fails: {e}", flush=True)
"""


def make_copy(dest: pathlib.Path, planted: bool) -> None:
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(ROOT / "src", dest / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    smoke = (ROOT / "chip_smoke.py").read_text()
    i = smoke.index("TRAIN_ARGV = [")
    j = smoke.index("]", i) + 1
    (dest / "chip_smoke.py").write_text(
        smoke[:i] + "TRAIN_ARGV = " + CPU_ARGV + smoke[j:])
    if planted:
        layers = dest / "src" / "repro_torch" / "models" / "layers.py"
        text = layers.read_text()
        if PSUM not in text:
            raise SystemExit("swiglu_mlp's psum line not found")
        layers.write_text(text.replace(PSUM, NO_PSUM))


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    base = pathlib.Path(argv[0]).resolve()
    rc = 0
    for name, planted in (("as_is", False), ("psum_dropped", True)):
        dest = base / name
        make_copy(dest, planted)
        print(f"== {name}", flush=True)
        env = dict(os.environ, PYTHONPATH=str(dest / "src"))
        rc |= subprocess.run([sys.executable, "-c", READ], cwd=dest,
                             env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
