"""The port's decode demo (``serve`` without ``--loop``) for the moe, ssm,
hybrid, encdec and vlm families and command-r, against the JAX
package's demo loop.

Each new arch at ``--smoke``: seeded prompts (then the vlm patch
embeddings and the encdec frames, drawn from the same generator in the
JAX demo's order), prefill and 8 greedy decode steps on the JAX
package's weights (`params_from_jax`) and its per-step block
permutations (``permutation(fold_in(PRNGKey(i), 1), n_blocks)``, which
its ``decode_step`` draws), with the exact head and the bandit head
(fp32; int8 too for qwen3-moe).  The tokens must be equal: the models
agree to rtol 1e-4 (``tests/test_torch_families.py``), which leaves
every argmax and every cascade cut of these draws alike.  The MoE
prefill drops assignments past capacity (16 tokens, 4 experts, top 2:
10 slots an expert), and the test checks that some were dropped.

Also: one ``--loop`` CLI run serves a new arch's vocab table, and the
vlm family's ``--prompt-len`` shorter than its patches is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import init_params
from repro.models.steps import decode_step as jax_decode_step
from repro.models.steps import prefill_step as jax_prefill
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import layers as TL

B, TOKENS = 2, 8


def _prompt_len(arch: str) -> int:
    return 20 if arch == "internvl2-26b" else 16


def _jax_demo(jcfg, params, P: int):
    """The JAX package's decode demo loop (``_run_decode_demo``), its
    inputs drawn in its order from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(0, jcfg.vocab, (B, P)), jnp.int32)
    kw = {}
    if jcfg.family == "vlm":
        kw["patch_embeds"] = jnp.asarray(
            rng.normal(size=(B, jcfg.n_patches, jcfg.d_model)), jnp.float32)
    if jcfg.family == "encdec":
        kw["enc_frames"] = jnp.asarray(
            rng.normal(size=(B, jcfg.encoder_seq, jcfg.d_model)),
            jnp.float32)
    _, caches = jax_prefill(params, jcfg, prompt, cache_len=P + TOKENS, **kw)
    dfn = jax.jit(lambda p, c, t, pos, k: jax_decode_step(p, jcfg, c, t, pos,
                                                          key=k))
    tok, out = prompt[:, -1:], []
    for i in range(TOKENS):
        nxt, caches = dfn(params, caches, tok, jnp.int32(P + i),
                          jax.random.PRNGKey(i))
        out.append(np.asarray(nxt))
        tok = nxt[:, None]
    return np.stack(out, axis=1)


def _jax_perm(i, n_blocks):
    key = jax.random.fold_in(jax.random.PRNGKey(i), 1)
    return torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)))


@pytest.mark.parametrize("arch,mips,precision", [
    ("qwen3-moe-30b-a3b", "exact", "fp32"),
    ("qwen3-moe-30b-a3b", "boundedme", "fp32"),
    ("qwen3-moe-30b-a3b", "boundedme", "int8"),
    ("grok-1-314b", "exact", "fp32"),
    ("grok-1-314b", "boundedme", "fp32"),
    ("mamba2-130m", "exact", "fp32"),
    ("mamba2-130m", "boundedme", "fp32"),
    ("jamba-v0.1-52b", "exact", "fp32"),
    ("jamba-v0.1-52b", "boundedme", "fp32"),
    ("whisper-medium", "exact", "fp32"),
    ("whisper-medium", "boundedme", "fp32"),
    ("internvl2-26b", "exact", "fp32"),
    ("internvl2-26b", "boundedme", "fp32"),
    ("command-r-35b", "exact", "fp32"),
    ("command-r-35b", "boundedme", "fp32")])
def test_family_decode_demo_tokens_match_jax(arch, mips, precision,
                                             monkeypatch, capsys):
    P = _prompt_len(arch)
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                             "--mips", mips, "--precision", precision,
                             "--eps", "0.1", "--batch", str(B),
                             "--prompt-len", str(P), "--tokens",
                             str(TOKENS)])
    cfg = serve.decode_config(args)
    jcfg = dataclasses.replace(
        jax_get_config(arch).smoke(), mips_mode=mips, mips_eps=0.1,
        mips_delta=0.1, mips_precision=precision)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    want = _jax_demo(jcfg, params, P)
    routed, real = [], TL.moe_layer

    def recording(x, p, cfg_):
        routed.append((x, p["router"], cfg_))
        return real(x, p, cfg_)
    monkeypatch.setattr(TL, "moe_layer", recording)
    out = serve.run_decode_demo(args, model=model, perm_of=_jax_perm)
    np.testing.assert_array_equal(out["tokens"], want)
    assert out["tokens"].dtype == np.int32 and out["model"] is model
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "first sequences" in text
    if mips == "boundedme":
        assert f"precision={precision}" in text and "plain PyTorch" in text
        head = model._mips_head             # built once for the 8 steps
        assert head.n_valid == cfg.vocab
        assert (head.quantized is None) == (precision == "fp32")
    if cfg.n_experts:
        # the prefill's MoE layers drop assignments past capacity
        dropped = 0
        for x, router, c in routed:
            S = x.shape[1]
            if S == 1:
                continue
            cap = TL.moe_capacity(c, S)
            probs = torch.softmax(x.float() @ router, -1)
            eidx = torch.sort(probs, dim=-1, descending=True,
                              stable=True).indices[..., :c.experts_per_token]
            for row in eidx:
                counts = torch.bincount(row.reshape(-1),
                                        minlength=c.n_experts)
                dropped += int((counts - cap).clamp(min=0).sum())
        assert routed and dropped > 0


def test_loop_serves_a_new_arch_table(capsys):
    """``--loop`` takes the new archs as they are: their vocab table
    through `make_serving_table`, every request served."""
    serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--loop",
                "--device", "cpu", "--requests", "24", "--batch", "4"])
    text = capsys.readouterr().out
    cfg = serve.get_config("qwen3-moe-30b-a3b").smoke()
    assert f"table=({cfg.padded_vocab},{cfg.d_model})" in text
    assert '"completed": 24' in text


def test_vlm_prompt_shorter_than_its_patches_is_refused(capsys):
    for argv, n in ((["--smoke", "--prompt-len", "15"], 16),
                    (["--prompt-len", "255"], 256)):
        with pytest.raises(SystemExit):
            serve.parse_args(["--arch", "internvl2-26b", *argv])
        err = capsys.readouterr().err
        assert "n_patches" in err and f">= {n}" in err, argv
    for argv in (["--smoke", "--prompt-len", "16"], ["--prompt-len", "272"],
                 ["--prompt-len", "8", "--loop"]):
        serve.parse_args(["--arch", "internvl2-26b", *argv])
    # the model refuses such a prefill too (the JAX package fails on a
    # shape mismatch there)
    args = serve.parse_args(["--arch", "internvl2-26b", "--smoke",
                             "--device", "cpu", "--prompt-len", "16"])
    model = serve.build_model(serve.decode_config(args), device="cpu")
    with pytest.raises(ValueError, match="patch embeddings"):
        model(torch.zeros((1, 8), dtype=torch.long),
              patch_embeds=torch.zeros((1, 16, model.cfg.d_model)),
              cache_len=12)
