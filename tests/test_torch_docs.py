"""The port's public API must stay documented, as the JAX package's is.

`tools/check_docstrings.py`'s walk, unedited, over ``src/repro_torch/``'s
counterparts of its audited modules (``core/boundedme_jax.py`` is the
port's ``core/boundedme_torch.py``): every public module, class and
function carries a docstring, and each contracted entry point mentions
its contract words.  The words that name a JAX mechanism the port does
not have are left out of the contracts: ``recompile`` / ``recompil``
(jit recompilation on a new shape or a new plan; the port's plans are
rebuilt, not compiled).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import check_docstrings  # noqa: E402

#: the port's name of a JAX module (the rest keep theirs)
COUNTERPART = {"core/boundedme_jax.py": "core/boundedme_torch.py"}
#: contract words that name a JAX mechanism
JAX_ONLY = {"recompile", "recompil"}
#: the JAX package's contracts, before a test swaps them for the port's
JAX_CONTRACTS = check_docstrings.API_CONTRACTS


def _port_contracts() -> dict:
    out = {}
    for rel, contracts in JAX_CONTRACTS.items():
        out[COUNTERPART.get(rel, rel)] = {
            qual: [w for w in words if w not in JAX_ONLY]
            for qual, words in contracts.items()}
    return out


@pytest.fixture
def port_audit(monkeypatch):
    monkeypatch.setattr(check_docstrings, "SRC", ROOT / "src" / "repro_torch")
    monkeypatch.setattr(check_docstrings, "AUDITED_MODULES", [
        COUNTERPART.get(rel, rel)
        for rel in check_docstrings.AUDITED_MODULES])
    monkeypatch.setattr(check_docstrings, "API_CONTRACTS", _port_contracts())
    return check_docstrings


def test_port_public_api_docstrings_covered(port_audit):
    problems = port_audit.check()
    assert not problems, "\n".join(problems)


def test_port_audit_covers_every_jax_module(port_audit):
    """Each audited JAX module has its counterpart in the port, and only
    the JAX-mechanism words are dropped from the contracts."""
    assert len(port_audit.AUDITED_MODULES) == len(
        set(port_audit.AUDITED_MODULES))
    for rel in port_audit.AUDITED_MODULES:
        assert (port_audit.SRC / rel).is_file(), rel
    dropped = {w for c in JAX_CONTRACTS.values()
               for words in c.values() for w in words} - {
        w for c in port_audit.API_CONTRACTS.values()
        for words in c.values() for w in words}
    assert dropped == JAX_ONLY


def test_port_audit_detects_a_missing_docstring(port_audit, tmp_path,
                                                monkeypatch):
    """The walk is not vacuous over the port: a public function without a
    docstring in an audited module is reported."""
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "mips.py").write_text(
        '"""Module."""\n\ndef mips_topk():\n    pass\n')
    monkeypatch.setattr(check_docstrings, "SRC", tmp_path)
    monkeypatch.setattr(check_docstrings, "AUDITED_MODULES", ["core/mips.py"])
    problems = port_audit.check()
    assert any("mips_topk has no docstring" in p for p in problems), problems
