"""The port's learning run and its last diagnostics (``tools/torch_*.py``).

* ``torch_learning_run``: its legs are the JAX scripts' python commands
  flag for flag (read from ``tools/tpu_learning_run*.sh`` and
  ``tpu_run_queue5.sh`` with ``shlex``), a failed leg stops the run, the
  whole chain rehearses on the CPU (ResNet10, canvas 64, 2 classes × 8
  images at 64 px, one epoch a leg) with every leg's ``##`` numbers in the
  summary, and both packages' loaders pad the last val batch alike, so
  their top-1s count the same rows.
* ``torch_cue_linear_probe``: ``fit_probe`` against the JAX tool's on the
  same seeded features, and the oracle glimpses of ``collect_split``
  against the JAX tool's on a 64-px wide-stripe corpus.
* ``torch_rls_cue_diag``: 2 steps of each arm; the from-init arm moves
  every parameter (no weight decay, as ``tests/test_frozen_params_guard.py``
  runs it), the pretrained arm leaves the stem and layer1 as loaded.
* ``torch_bn_stat_bench``: the JAX tool's ``SHAPES`` (read with ``ast``),
  both statistic forms against float64 on the CPU.
* ``torch_multiprocess_check``: 2 CPU processes over gloo, launched with
  positional arguments and with the ``MAAI_*`` variables.
* None of the five tools imports JAX or the JAX package, and none falls
  back to the CPU when the card is missing.

torch runs on one thread where JAX runs in the same process.
"""

import ast
import json
import os
import shlex
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import torch_bn_stat_bench as bnb  # noqa: E402
from tools import torch_cue_linear_probe as cue  # noqa: E402
from tools import torch_learning_run as lr  # noqa: E402
from tools import torch_multiprocess_check as mpc  # noqa: E402
from tools import torch_rls_cue_diag as diag  # noqa: E402

TOOLS = ["torch_learning_run", "torch_cue_linear_probe", "torch_rls_cue_diag",
         "torch_bn_stat_bench", "torch_multiprocess_check"]
JAX_SCRIPTS = ["tools/tpu_learning_run.sh", "tools/tpu_learning_run2.sh",
               "tools/tpu_learning_run3.sh", "tools/tpu_run_queue5.sh"]
# the scripts' path variables, as the leg table writes them (the model
# paths first: they start with $WORK)
PATHS = [("$WORK/simclr/model_best.msgpack", "{model}"), ("$BB", "{model}"),
         ("$DATA", "{data}"), ("$CACHE", "{cache}"), ("$WORK", "{work}")]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_commands(script: str) -> dict:
    """``{line: (timeout, driver script, args)}`` of every python driver
    command of a JAX shell script: ``\\`` continuations joined, split with
    ``shlex`` (comments dropped), cut at the first redirection or pipe,
    path variables replaced by the leg table's placeholders."""
    lines = open(os.path.join(ROOT, script)).read().split("\n")
    out, i = {}, 0
    while i < len(lines):
        start, line = i + 1, lines[i]
        while line.endswith("\\"):
            i += 1
            line = line[:-1] + " " + lines[i]
        i += 1
        try:
            toks = shlex.split(line, comments=True)
        except ValueError:      # a line of queue5's multi-line `python -c "..."`
            continue
        for j, tok in enumerate(toks[:-1]):
            if tok == "python" and toks[j + 1].endswith(".py") and "/" not in toks[j + 1]:
                args = toks[j + 2:]
                cut = next((k for k, a in enumerate(args) if a in ("2>&1", "|")), len(args))
                filled = []
                for a in args[:cut]:
                    for var, place in PATHS:
                        a = a.replace(var, place)
                    filled.append(a)
                out[start] = (int(toks[j - 1]), toks[j + 1], filled)
    return out


def test_legs_are_the_jax_commands_flag_for_flag():
    commands = {(script, line): cmd for script in JAX_SCRIPTS
                for line, cmd in jax_commands(script).items()}
    assert len(commands) == 9, sorted(commands)
    seen = set()
    for leg in lr.LEGS:
        script, line = leg.script.split(":")
        timeout, driver, args = commands[(script, int(line))]
        assert driver == f"{leg.driver}.py", leg.name
        assert args == list(leg.argv), (leg.name, args, leg.argv)
        assert timeout == leg.timeout, leg.name
        seen.add((script, int(line)))
    assert seen == set(commands)
    # each leg that reads a model reads its SimCLR leg's, from its own $WORK
    for leg in lr.LEGS:
        if leg.model_from:
            assert lr.LEG_BY_NAME[leg.model_from].work == leg.work
            assert lr.LEG_BY_NAME[leg.model_from].driver == "contrastive_learning"


def test_leg_argv_fills_the_paths_and_overrides():
    leg = lr.LEG_BY_NAME["part2_rls"]
    argv = lr.leg_argv(leg, "/d", "/w", "/c", "cpu", epochs=3, arch="ResNet10", batch=8,
                       canvas=64)
    assert argv[:2] == ["/w/lr50/simclr/model_best.pth.tar", "/d"]
    assert lr.flag_value(argv, "--epochs") == "3"
    assert lr.flag_value(argv, "--backbone") == "ResNet10"
    assert lr.flag_value(argv, "-b") == "8"
    assert lr.flag_value(argv, "--checkpoint-dir") == "/w/lr50/rls"
    assert argv[-4:] == ["--canvas-size", "64", "--device", "cpu"]
    assert lr.chance(leg, argv) == pytest.approx(10.0)
    simclr = lr.leg_argv(lr.LEG_BY_NAME["part1_simclr"], "/d", "/w", "/c")
    assert lr.chance(lr.LEG_BY_NAME["part1_simclr"], simclr) == pytest.approx(100 / 191)
    assert simclr[-2:] == ["--device", "cuda"]


def test_a_failed_leg_is_reported():
    leg = lr.LEG_BY_NAME["part1_probe"]
    argv = lr.leg_argv(leg, "/d", "/w", "/c", "cpu", epochs=2)
    two = "##Top-1 12.5\n##Top-5 50.0\n##Top-1 25.0\n##Top-5 75.0\n"
    assert "problem" not in lr.leg_summary(leg, argv, two, 1.0, 0)
    assert lr.leg_summary(leg, argv, two, 1.0, 1)["problem"] == "exit code 1"
    assert lr.leg_summary(leg, argv, "Traceback ...", 1.0, 0)["problem"] == "no ## line"
    assert "expected 2" in lr.leg_summary(leg, argv, two[:25], 1.0, 0)["problem"]
    s = lr.leg_summary(leg, argv, two, 1.0, 0)
    assert s["metrics"] == {"top1": [12.5, 25.0], "top5": [50.0, 75.0]}
    assert s["best"]["top1"] == 25.0


def test_learning_run_rehearses_on_the_cpu(tmp_path):
    out = tmp_path / "summary.json"
    cmd = [sys.executable, os.path.join(ROOT, "tools", "torch_learning_run.py"),
           "--device", "cpu", "--arch", "ResNet10", "--batch", "8", "--size", "64",
           "--classes", "2", "--per-class", "8", "--epochs-scale", "0", "--out", str(out)]
    # no --work: the run's checkpoints (~1 GB, the DETR and RLS legs' AdamW
    # states) go to a temporary directory the tool removes
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    summary = json.loads(out.read_text())
    assert summary["card"] == "cpu"
    assert [s["name"] for s in summary["legs"]] == [leg.name for leg in lr.LEGS]
    for s in summary["legs"]:
        assert "problem" not in s, s
        keys = [k for k, _, _ in lr.METRICS[lr.LEG_BY_NAME[s["name"]].driver]]
        assert sorted(s["metrics"]) == sorted(keys)
        for k in keys:
            assert len(s["metrics"][k]) == 1 and np.isfinite(s["metrics"][k][0]), s
        assert len(s["loss"]) == 1 and np.isfinite(s["loss"][0])
        assert s["jax_tpu"] == lr.JAX_TPU[s["name"]]


def test_both_packages_pad_the_last_val_batch_alike(tmp_path):
    """10 val images at b=4: 3 batches, 12 rows, the last image repeated;
    the drivers average top-1 over batches of ``b`` rows, so both count the
    repeats (as 160 images at b=96 give 192 rows)."""
    from multimodal_active_ai_tpu.data.loader import HostLoader as JaxLoader

    from multimodal_active_ai_tpu_torch.data.loader import HostLoader

    lr.make_corpus(str(tmp_path), 5, 1, 2, 32)
    from multimodal_active_ai_tpu_torch.data.readers import list_image_folder
    files, labels, _ = list_image_folder(str(tmp_path / "val"))
    got = {}
    for name, cls in (("jax", JaxLoader), ("port", HostLoader)):
        loader = cls(files, labels, batch_size=4, canvas_size=32, num_threads=1,
                     use_native=False)
        got[name] = np.concatenate([np.asarray(lab) for _, lab in loader])
    assert len(got["port"]) == 12
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"][9:], [labels[-1]] * 3)


def seeded_features(n=24, m=8, r=3, d=32, c=4, seed=0):
    rng = np.random.RandomState(seed)
    ty, vy = rng.randint(0, c, n), rng.randint(0, c, m)
    centers = rng.randn(c, d).astype(np.float32)

    def feats(y):
        return ((centers[y][:, None] + 3 * rng.randn(len(y), r, d)) * 20 + 100).astype(np.float32)

    return feats(ty), ty, feats(vy), vy, c


def test_fit_probe_matches_the_jax_tool():
    """The JAX tool returns top-1s only; its logits are read where it hands
    them to numpy. Both sides run float32 Adam from the same standardized
    features: each is ~4e-4 of the largest logit from a float64 run here,
    so they are held to each other normwise at 1e-3."""
    from tools import cue_linear_probe as jcue

    tx, ty, vx, vy, c = seeded_features()
    seen = []

    class RecordingNumpy(types.ModuleType):
        def __getattr__(self, name):
            return getattr(np, name)

        def asarray(self, a, *args, **kwargs):
            out = np.asarray(a, *args, **kwargs)
            seen.append(out)
            return out

    jcue.np = RecordingNumpy("numpy")
    try:
        want = jcue.fit_probe(tx, ty, vx, vy, c, 100)
    finally:
        jcue.np = np
    jax_val, jax_train = seen[0], seen[1]     # v_img's, then top1's of the train logits
    assert cue.fit_probe(tx, ty, vx, vy, c, 100) == want
    train, val = cue.probe_logits(tx, ty, vx, c, 100)
    for got, ref in ((train, jax_train), (val, jax_val)):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.fixture(scope="module")
def cue_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cue64"))
    return lr.make_corpus(root, 4, 3, 2, 64, cue="wide-stripe")


def test_oracle_glimpses_match_the_jax_tool(cue_corpus):
    from multimodal_active_ai_tpu.config import RLSConfig as JaxConfig
    from multimodal_active_ai_tpu.config import parse_into as jax_parse
    from multimodal_active_ai_tpu.ops import retina as jax_retina
    from tools import cue_linear_probe as jcue

    from multimodal_active_ai_tpu_torch.config import RLSConfig, parse_into
    from multimodal_active_ai_tpu_torch.ops import retina

    argv = ["none", cue_corpus, "--dataset", "imagenet", "--num-classes", "4", "-b", "4",
            "--canvas-size", "64", "-j", "1"]
    jr, jo, jy = jcue.collect_split(jax_parse(JaxConfig, argv), "val", 3, 0.9,
                                    jax_retina.RetinaConfig(canvas_size=64), 16)
    pr, po, py = cue.collect_split(parse_into(RLSConfig, argv + ["--device", "cpu"]), "val", 3,
                                   0.9, retina.RetinaConfig(canvas_size=64), 16,
                                   torch.device("cpu"))
    np.testing.assert_array_equal(py, jy)
    assert pr.shape == jr.shape == po.shape == (8, 3, 30 * 30 * 12)
    # the same labeled retina at the same fixation: float32 glimpses on 0..255
    assert np.abs(po - jo).max() <= 1e-3
    # random fixations land elsewhere than the oracle's
    assert np.abs(pr - po).max() > 1.0


def test_cue_probe_main_on_the_cpu(cue_corpus, capsys):
    res = cue.main(["none", cue_corpus, "-b", "4", "--canvas-size", "64", "--probe-steps", "20",
                    "--device", "cpu", "-j", "1"])
    assert set(res) == {"random-fix", "oracle-fix"}
    assert all(0.0 <= x <= 1.0 for v in res.values() for x in v)
    assert "VERDICT" in capsys.readouterr().out


@pytest.fixture(scope="module")
def diag_cfg(cue_corpus, tmp_path_factory):
    from multimodal_active_ai_tpu_torch.config import RLSConfig, parse_into
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt

    path = str(tmp_path_factory.mktemp("simclr") / "model_best.pth.tar")
    encoder = SimCLRModule("ResNet10", generator=torch.Generator().manual_seed(0))
    ckpt.save_checkpoint({"epoch": 1, "state_dict": encoder.state_dict()}, False, filename=path)
    argv = [path, cue_corpus, "--backbone", "ResNet10", "--canvas-size", "64", "-b", "4",
            "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "2",
            "--dim_feedforward", "64", "--wd", "0", "-j", "1", "--device", "cpu"]
    return parse_into(RLSConfig, diag.DEFAULTS + argv)


@pytest.mark.parametrize("pretrained", [False, True], ids=["from-init", "pretrained"])
def test_rls_cue_diag_arms(diag_cfg, pretrained):
    from multimodal_active_ai_tpu_torch.detr_image_classification import load_backbone
    from multimodal_active_ai_tpu_torch.models import detr as detr_models

    assert (diag_cfg.num_fixations, diag_cfg.num_of_actions, diag_cfg.gamma) == (3, 10, 0.0)
    init, _ = detr_models.build(diag_cfg, num_classes=4, dtype=torch.float32,
                                generator=torch.Generator().manual_seed(diag_cfg.seed))
    if pretrained:
        load_backbone(init, diag_cfg.backbone_path, torch.device("cpu"))
    before = {k: v.detach().clone() for k, v in init.named_parameters()}
    first, last, model = diag.run_arm("test", diag_cfg, pretrained, 2, torch.device("cpu"))
    assert np.isfinite(first) and np.isfinite(last)
    moved = {k: not torch.equal(before[k], v) for k, v in model.named_parameters()}
    frozen = {k for k in moved if k.startswith("backbone.0.body.")
              and not k[len("backbone.0.body."):].startswith(("layer2", "layer3", "layer4"))}
    assert frozen
    if pretrained:
        assert not any(moved[k] for k in frozen)
        assert all(moved[k] for k in moved if k not in frozen)
    else:
        assert all(moved.values()), [k for k, v in moved.items() if not v]


def test_bn_stat_bench_shapes_and_forms():
    tree = ast.parse(open(os.path.join(ROOT, "tools", "bn_stat_bench.py")).read())
    # its entries are products of integer literals
    jax_shapes = next(eval(ast.unparse(node.value), {"__builtins__": {}}) for node in tree.body
                      if isinstance(node, ast.Assign) and node.targets[0].id == "SHAPES")
    assert bnb.SHAPES == jax_shapes
    gen = torch.Generator().manual_seed(0)
    for n, c in bnb.SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(n // 16, c, generator=gen) * 2 + 1).to(dtype)
            r = bnb.check_shape(x)
            assert r["ok"], (n, c, dtype)
            for form in ("bn", "b2"):
                assert max(r[form]) <= 1e-5, (n, c, dtype, form, r[form])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("launch", ["positional", "maai"])
def test_multiprocess_check_two_cpu_ranks(tmp_path, launch):
    script = os.path.join(ROOT, "tools", "torch_multiprocess_check.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    coordinator = f"localhost:{_free_port()}"
    procs = []
    for r in range(2):
        if launch == "positional":
            cmd, rank_env = [sys.executable, script, str(r), "2", coordinator, "--device",
                             "cpu"], env
        else:
            cmd = [sys.executable, script, "--device", "cpu"]
            rank_env = dict(env, MAAI_NUM_PROCESSES="2", MAAI_PROCESS_ID=str(r),
                            MAAI_COORDINATOR=f"file://{tmp_path / 'rendezvous'}")
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=rank_env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"MULTIPROCESS OK rank {r}/2" in out and "backend gloo" in out, out
        assert "cross-rank sum 36.0 == 36.0" in out, out


def test_tools_import_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.')\n"
            + "".join(f"import tools.{t}\n" for t in TOOLS)
            + "bad = sorted(m for m in sys.modules if m in ('jax', 'multimodal_active_ai_tpu')"
              " or m.startswith(('jax.', 'jaxlib', 'flax', 'optax', "
              "'multimodal_active_ai_tpu.')))\n"
            + "print(bad); sys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_tools_need_the_card_unless_told_cpu(cue_corpus, tmp_path):
    """Without ``--device cpu`` each tool stops here (no CUDA): none falls
    back to the CPU."""
    assert not torch.cuda.is_available()
    assert lr.main(["--legs", "part1_simclr", "--work", str(tmp_path)]) == 1
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cue.main(["none", cue_corpus])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diag.main(["none", cue_corpus, "--arm", "from-init"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bnb.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mpc.check("cuda")
