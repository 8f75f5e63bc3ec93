"""The port's examples (``examples_torch/``) against the JAX examples
(``examples/``), loaded by path and run as they are, at small sizes.

* quickstart: the JAX ``main()`` at a (2000, 1024) table — its size
  constants swapped in a copy of its code object, since it sizes sigma
  and the plan from its own ``n, N`` and not from the table, and
  ``mf_dataset`` patched to hand it the port's table — against the
  port's ``run`` on the same table with the JAX key's block permutation:
  the printed lines (bar the wall times), the exact ids, each search's
  ids, speedup and overlap equal.
* Frank-Wolfe: both ``frank_wolfe`` functions at n = 200, N = 2,000, 10
  iterations, for each LMO: every pick and the multiplies equal, ``x`` to
  rtol 1e-5.
* serve_decode_mips: the example's config at vocab 4,096, B = 2, P = 4,
  T = 4, on the JAX weights (`params_from_jax`) and the JAX decode step's
  permutations: tokens equal to the JAX decode loop's, per head.
* train_lm: the command equal to the JAX wrapper's, the module swapped
  and ``--device`` added; ``--steps 2 --device cpu`` trains with finite
  losses; without ``--device cpu`` and no card it fails loudly.
* No example imports ``jax`` or ``repro``; each asked for the card
  without one raises.
"""

import dataclasses
import importlib.util
import math
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.core import make_plan as jax_make_plan
from repro.models.model import init_params
from repro.models.steps import decode_step as jax_decode_step
from repro.models.steps import prefill_step as jax_prefill_step
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import mf_dataset

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "serve_decode_mips", "frank_wolfe_lmo", "train_lm")


def _load(folder: str, name: str):
    path = ROOT / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    env.update(extra)
    return env


# --- quickstart -------------------------------------------------------------

QS_SHAPE = (2000, 1024)


def _jax_quickstart_main(jq, n: int, N: int):
    """The JAX example's ``main`` with its ``n, N = 20_000, 8192`` made
    ``n, N``: a copy of its code object, the file untouched."""
    code = jq.main.__code__
    consts = tuple((n, N) if c == (20_000, 8192) else c
                   for c in code.co_consts)
    assert consts != code.co_consts
    return types.FunctionType(code.replace(co_consts=consts), jq.__dict__)


def test_quickstart_matches_jax_example(monkeypatch, capsys):
    jq = _load("examples", "quickstart")
    tq = _load("examples_torch", "quickstart")
    n, N = QS_SHAPE
    V, q = mf_dataset(n, N, rank=32, seed=0)
    asked = []

    def data(*a, **k):
        asked.append((a, k))
        return V, q
    import repro.data.synthetic as jsyn
    monkeypatch.setattr(jsyn, "mf_dataset", data)
    found = []
    real_mips = jq.mips_topk

    def recording(*a, **k):
        out = real_mips(*a, **k)
        found.append(np.asarray(out[0]))
        return out
    monkeypatch.setattr(jq, "mips_topk", recording)
    _jax_quickstart_main(jq, n, N)()
    want = capsys.readouterr().out.splitlines()
    assert asked == [((n, N), {"rank": 32, "seed": 0})]

    n_blocks = math.ceil(N / 128)
    perm = torch.from_numpy(np.array(jax.random.permutation(
        jax.random.PRNGKey(0), n_blocks)))
    lines = []
    out = tq.run(V, q, device="cpu", perm=perm, log=lines.append)

    def no_wall(line):
        return re.sub(r"wall \d+\.\d+s", "wall", line)
    assert [no_wall(s) for s in lines] == [no_wall(s) for s in want]
    assert len(lines) == 4 and lines[0].startswith("exact top-5: [")
    sigma, vr = tq.knobs(V, q)
    for run, jids in zip(out["runs"], found, strict=True):
        np.testing.assert_array_equal(run["ids"].numpy(), jids)
        assert run["speedup"] == jax_make_plan(
            n, N, K=5, eps=run["mult"] * sigma, delta=0.1, value_range=vr,
            block=128).speedup
        assert run["overlap"] == len(set(jids.tolist()) & set(
            out["exact"].tolist()))


# --- Frank-Wolfe ------------------------------------------------------------


class _RecordingNumpy:
    """numpy, with each ``argmax`` result recorded (the JAX example's
    exact LMO picks)."""

    def __init__(self, picks):
        self._picks = picks

    def argmax(self, a, *args, **kw):
        i = np.argmax(a, *args, **kw)
        self._picks.append(int(i))
        return i

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.mark.parametrize("lmo,eps", [("exact", None), ("boundedme", 0.2),
                                     ("boundedme", 0.5)])
def test_frank_wolfe_matches_jax_example(lmo, eps, monkeypatch):
    jf = _load("examples", "frank_wolfe_lmo")
    tf = _load("examples_torch", "frank_wolfe_lmo")
    S, target = tf.problem(200, 2_000)
    picks = []
    monkeypatch.setattr(jf, "np", _RecordingNumpy(picks))
    real_bme = jf.bounded_me

    def recording(*a, **k):
        res = real_bme(*a, **k)
        picks.append(int(res.topk[0]))
        return res
    monkeypatch.setattr(jf, "bounded_me", recording)
    jx, jpulls = jf.frank_wolfe(S, target, iters=10, lmo=lmo, eps=eps or 0)
    trace = []
    x, pulls = tf.frank_wolfe(S, target, iters=10, lmo=lmo, eps=eps or 0,
                              device="cpu", trace=trace)
    assert [t[1] for t in trace] == picks and len(picks) == 10
    assert pulls == jpulls and sum(t[2] for t in trace) == pulls
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-5)


def test_frank_wolfe_run_prints_the_jax_lines():
    tf = _load("examples_torch", "frank_wolfe_lmo")
    S, target = tf.problem(100, 500)
    lines = []
    out = tf.run(S, target, iters=3, device="cpu", log=lines.append)
    assert [r["tag"] for r in out] == ["exact", "boundedme(eps=0.2)",
                                       "boundedme(eps=0.5)"]
    for line, r in zip(lines, out, strict=True):
        assert re.fullmatch(
            rf"{re.escape(r['tag']):18s}: rel err {r['rel_err']:.4f}, LMO "
            rf"multiplies {r['multiplies']:.2f}x naive, \d+\.\ds", line)
    assert out[0]["multiplies"] == 1.0


# --- serve_decode_mips ------------------------------------------------------


def _jax_perm(i, n_blocks):
    key = jax.random.fold_in(jax.random.PRNGKey(i), 1)
    return torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)))


def test_serve_decode_mips_tokens_match_jax():
    ts = _load("examples_torch", "serve_decode_mips")
    B, P, T, vocab = 2, 4, 4, 4_096
    cfg = ts.make_config(vocab=vocab)
    jcfg = dataclasses.replace(
        JAX_REGISTRY["qwen1.5-0.5b"].smoke(), vocab=vocab, vocab_pad=2048,
        d_model=256, n_heads=8, d_head=32, n_kv_heads=8)
    params = jax.jit(init_params, static_argnums=0)(jcfg,
                                                    jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    lines = []
    out = ts.run(cfg, B=B, P=P, T=T, device="cpu", model=model,
                 perm_of=_jax_perm, log=lines.append)
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, vocab, (B, P)), jnp.int32)
    for mode, eps in ts.MODES:
        c = dataclasses.replace(jcfg, mips_mode=mode,
                                mips_eps=eps or jcfg.mips_eps)
        _, caches = jax.jit(lambda p, x, c=c: jax_prefill_step(
            p, c, x, cache_len=P + T))(params, prompts)
        dfn = jax.jit(lambda p, ca, t, pos, k, c=c: jax_decode_step(
            p, c, ca, t, pos, key=k))
        tok, toks = prompts[:, -1:], []
        for i in range(T):
            nxt, caches = dfn(params, caches, tok, jnp.int32(P + i),
                              jax.random.PRNGKey(i))
            toks.append(np.asarray(nxt))
            tok = nxt[:, None]
        tag = mode if eps is None else f"{mode}(eps={eps})"
        np.testing.assert_array_equal(out["tokens"][tag], np.stack(toks, 1))
    assert out["padded_rows"] == cfg.padded_vocab == vocab
    assert lines[-1] == (f"vocab = {vocab} | the bandit searched {vocab} "
                         f"padded rows with zero preprocessing")
    assert [s.split(":")[0].strip() for s in lines[3:5]] == [
        "boundedme(eps=0.1)", "boundedme(eps=0.4)"]


def test_serve_decode_mips_config_is_the_jax_example_s():
    ts = _load("examples_torch", "serve_decode_mips")
    cfg = ts.make_config()
    want = dataclasses.replace(
        JAX_REGISTRY["qwen1.5-0.5b"].smoke(), vocab=151_936, vocab_pad=2048,
        d_model=256, n_heads=8, d_head=32, n_kv_heads=8)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.padded_vocab == 153_600 and cfg.dtype == "float32"


# --- train_lm ---------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True])
def test_train_lm_command_matches_jax_wrapper(full, monkeypatch, capsys,
                                              tmp_path):
    jt = _load("examples", "train_lm")
    tt = _load("examples_torch", "train_lm")
    argv = ["--steps", "7", "--ckpt-dir", str(tmp_path)] + (
        ["--full"] if full else [])
    calls = []
    monkeypatch.setattr(jt, "subprocess", types.SimpleNamespace(
        call=lambda cmd: calls.append(cmd) or 0))
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    with pytest.raises(SystemExit) as done:
        jt.main()
    assert done.value.code == 0
    want = list(calls[0])
    want[want.index("repro.launch.train")] = "repro_torch.launch.train"
    at = want.index("--lr") + 2
    want[at:at] = ["--device", "cuda"]
    assert tt.command(tt.parse_args(argv)) == want
    assert ("--smoke" in want) == (not full)
    default = tt.parse_args([])
    assert default.device == "cuda" and default.arch == "mamba2-130m"
    assert Path(default.ckpt_dir).parent == Path(
        __import__("tempfile").gettempdir())


def test_train_lm_trains_on_cpu_when_asked(tmp_path):
    ckpt = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "train_lm.py"),
         "--steps", "2", "--device", "cpu", "--ckpt-dir", str(ckpt)],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "repro_torch.launch.train" in proc.stdout.splitlines()[0]
    losses = [float(m) for m in re.findall(r"step=\d+ loss=(\S+)",
                                           proc.stdout)]
    assert len(losses) == 2 and all(np.isfinite(losses)), proc.stdout
    assert (ckpt / "step_00000002").is_dir()


def test_train_lm_without_a_card_fails_loudly(tmp_path):
    ckpt = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "train_lm.py"),
         "--steps", "2", "--ckpt-dir", str(ckpt)],
        cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "loss=" not in proc.stdout and not ckpt.exists()


# --- every example ----------------------------------------------------------


def test_examples_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"for name in {EXAMPLES!r}:\n"
        f"    path = {str(ROOT / 'examples_torch')!r} + '/' + name + '.py'\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "BAD []"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["quickstart", "serve_decode_mips",
                                  "frank_wolfe_lmo"])
def test_examples_ask_for_the_card_by_default(name):
    mod = _load("examples_torch", name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if name == "quickstart":
            V, q = mf_dataset(64, 256, rank=8, seed=0)
            mod.run(V, q, log=lambda s: None)
        elif name == "serve_decode_mips":
            mod.run(mod.make_config(vocab=512), B=1, P=2, T=1,
                    log=lambda s: None)
        else:
            S, target = mod.problem(16, 64)
            mod.frank_wolfe(S, target, iters=1)
