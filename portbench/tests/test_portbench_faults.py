"""Both kinds of entry driven end to end on the CPU at a tiny size, with
the plain versions of the port's kernels: a sound run is ``correct``,
the control reads above the limit, and each fault the cell can have,
planted in the timed path, turns ``correct`` false.  (On the card the
controls run through ``portbench/control.py`` at the cells' own size.)"""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from repro_torch.launch import engine as engine_mod
from repro_torch.models import steps as steps_mod

SERVE = harness.Cell(
    workload={"name": "tiny-serve", "chips": 1},
    config={"vocab_size": 600, "hidden_size": 64,
            "initializer_range": 0.02, "dtype": "bfloat16",
            "engine": {"K": 4, "eps": 0.1, "delta": 0.1, "tile": 8,
                       "block": 16, "precision": "fp32"}},
    traffic={"driver": "serve_closed", "callers": 8, "batch_size": 4,
             "deadline_ms": 2.0, "zipf_s": 1.0, "query_chunk": 64,
             "pool_queries_per_s": 100,
             "warmup_batches": 1,
             "trace_seconds": 0.1, "check_requests": 32},
    limits={"score_err": {"limit": 1e-5}, "top1_err": {"limit": 1e-5},
            "rank_shortfall": {"limit": 0.3}},
    driver=harness.PKG / "drivers" / "serve_closed.py",
    end_to_end=[], per_layer=[])

DECODE = harness.Cell(
    workload={"name": "tiny-decode", "chips": 1},
    config={"hidden_size": 64, "intermediate_size": 128,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "num_hidden_layers": 2, "vocab_size": 512, "rope_theta": 1e4,
            "layer_norm_eps": 1e-6, "tie_word_embeddings": True,
            "dtype": "bfloat16",
            "port": {"arch": "command-r-35b", "overrides": {
                "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                "tie_embeddings": True,
                "d_head": 16, "d_ff": 128, "vocab": 512, "vocab_pad": 128,
                "rope_theta": 1e4, "mips_mode": "boundedme",
                "mips_eps": 0.1, "mips_delta": 0.1}}},
    traffic={"driver": "decode_rounds", "sessions": 4, "context": 12,
             "tokens_per_round": 6, "prefill_group": 2, "warmup_steps": 1,
             "trace_steps": 2, "check_sessions": 2},
    limits={"logit_gap": {"limit": 0.01}},
    driver=harness.PKG / "drivers" / "decode_rounds.py",
    end_to_end=[], per_layer=[])


def _run(cell, seconds, control=False):
    driver = harness.load_module(cell.driver, "portbench_test_driver")
    out = driver.run(harness.Run(cell=cell, seed=2 ** 35 + 17,
                                 seconds=seconds, trace=False, device="cpu"),
                     control=control)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    return out, harness.finish(cell, out, 0.0, False, dev)


def test_serve_sound_and_its_control():
    out, line = _run(SERVE, 0.2, control=True)
    assert line["correct"] and out["info"]["checked"] > 0
    assert max(out["control"][k] for k in ("score_err", "top1_err")) \
        > 3 * max(out["checks"][k]["value"] for k in ("score_err",
                                                       "top1_err"))
    assert any(out["control"][k] > SERVE.limits[k]["limit"]
               for k in ("score_err", "top1_err"))
    # the reference's planted fault (the best row, the rest at random)
    assert out["fault"]["rank_shortfall"] \
        > 3 * out["checks"]["rank_shortfall"]["value"]
    assert out["fault"]["rank_shortfall"] \
        > SERVE.limits["rank_shortfall"]["limit"]


def _altered(orig):
    def dispatch(self, Qbuf, perm):
        ids, scores, rounds, dt = orig(self, Qbuf, perm)
        return (ids + 1) % self.n, scores, rounds, dt
    return dispatch


def _half_batch(orig):
    def dispatch(self, Qbuf, perm):
        h = Qbuf.shape[0] // 2
        ids, scores, rounds, dt = orig(self, Qbuf[:h], perm)
        full_ids = ids.repeat(2, 0)
        full_scores = scores.repeat(2, 0)
        full_ids[h:], full_scores[h:] = 0, 0.0
        return full_ids, full_scores, rounds, dt
    return dispatch


def _best_only(orig):
    """The executor's best row kept, the other answers drawn at random
    and scored exactly: only ranks 2..K can tell."""
    def dispatch(self, Qbuf, perm):
        ids, scores, rounds, dt = orig(self, Qbuf, perm)
        g = torch.Generator().manual_seed(5)
        for b in range(ids.shape[0]):
            rest = [int(i) for i in torch.randperm(self.n, generator=g)
                    if int(i) != ids[b, 0]][:ids.shape[1] - 1]
            ids[b, 1:] = rest
            rows = self._table[torch.as_tensor(ids[b])].float()
            scores[b] = (rows @ torch.as_tensor(Qbuf[b])).numpy() / Qbuf.shape[1]
        return ids, scores, rounds, dt
    return dispatch


@pytest.mark.parametrize("fault", [_altered, _half_batch, _best_only])
def test_serve_faults_are_not_correct(monkeypatch, fault):
    orig = engine_mod.CascadeExecutor.dispatch
    monkeypatch.setattr(engine_mod.CascadeExecutor, "dispatch", fault(orig))
    _, line = _run(SERVE, 0.2)
    assert not line["correct"]


def test_decode_sound_and_its_control():
    out, line = _run(DECODE, 0.3, control=True)
    assert line["correct"] and out["info"]["steps"] > 0
    assert out["control"]["logit_gap"] > 3 * out["checks"]["logit_gap"][
        "value"]
    assert out["control"]["logit_gap"] > DECODE.limits["logit_gap"]["limit"]


def _state_unchanged(orig):
    def step(model, cfg, caches, tokens, pos, perm=None, mesh=None):
        copy = [{k: v.clone() for k, v in c.items()} for c in caches]
        return orig(model, cfg, copy, tokens, pos, perm=perm, mesh=mesh)
    return step


def _token_altered(orig):
    def step(model, cfg, caches, tokens, pos, perm=None, mesh=None):
        tok, caches = orig(model, cfg, caches, tokens, pos, perm=perm,
                           mesh=mesh)
        return (tok + 1) % cfg.vocab, caches
    return step


def _half_sessions(orig):
    def step(model, cfg, caches, tokens, pos, perm=None, mesh=None):
        h = tokens.shape[0] // 2
        part = [{k: v[:h] for k, v in c.items()} for c in caches]
        tok, _ = orig(model, cfg, part, tokens[:h], pos, perm=perm,
                      mesh=mesh)
        return torch.cat([tok, torch.zeros_like(tok)]), caches
    return step


@pytest.mark.parametrize("fault", [_state_unchanged, _token_altered,
                                   _half_sessions])
def test_decode_faults_are_not_correct(monkeypatch, fault):
    monkeypatch.setattr(steps_mod, "decode_step",
                        fault(steps_mod.decode_step))
    # a cache left unchanged shows from the second step on: a window of
    # a second holds some even on a loaded machine
    out, line = _run(DECODE, 1.0)
    assert out["info"]["steps"] >= 2
    assert not line["correct"]
