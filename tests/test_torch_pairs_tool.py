"""tools/card_pairs.py rehearsed on the CPU: it refuses to run without
CUDA or without the commit it runs at; its case table; its roles in processes of their own, the killed and
resumed prover among them, run here with `--device cpu`; its refusal of a
case whose prove process launched a kernel of its floors no time (here,
where the kernels' plain versions run, every count is 0); and its file,
which replaces its maker's pairs and keeps the other maker's."""

import os
import subprocess
import sys

import pytest
import torch

from _torch_support import one_torch_thread, repo_module  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CP = repo_module("tools/card_pairs.py")


def test_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device; the tool would run")
    out = tmp_path / "pairs.json"
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "card_pairs.py"),
                        "--rev", "0" * 40, "--out", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout and not out.exists()


@pytest.mark.parametrize("rev", [None, "unknown", "5d4d92a", "g" * 40])
def test_refuses_a_rev_that_is_no_commit(tmp_path, capsys, rev):
    out = tmp_path / "pairs.json"
    argv = ["--reference", "--out", str(out)]
    with pytest.raises(SystemExit) as e:
        CP.main(argv + ([] if rev is None else ["--rev", rev]))
    assert e.value.code == 2 and "--rev" in capsys.readouterr().err
    assert not out.exists()


def test_case_table():
    """The suite's cases are `workloads.case`'s documents; `dna` is
    chip_smoke.py's 1 MB dna.sh document and regex; the table cases are
    those whose lookup table reaches the sumcheck floor; only `resume`
    checkpoints, with `-b 2`."""
    from reef_tpu_torch import workloads
    from reef_tpu_torch.backend import routes
    cs = CP.case_inputs(CP.CASES["dna"])
    size = CP.CASES["dna"]["size"]
    assert cs[2].decode() == workloads.case("dna", size)[2].decode()
    assert cs[:4] == ("dna", f"^.{{{size - 24}}}ATGGGCTACAGAAACCGTGCCAAA.*",
                      cs[2], [])
    assert routes.DEFAULT.sumcheck == 1 << 14
    assert {n for n, s in CP.CASES.items() if s.get("table")} == \
        {"dna", "proj_hybrid"}
    for name, spec in {**CP.CASES, **CP.REFERENCE_CASES}.items():
        argv = CP.role_argvs(name, spec)
        assert [a[1] for a in argv.values()] == ["--commit", "--prove",
                                                 "--verify"]
        assert "--device" not in argv["prove"]
        assert ("--checkpoint" in argv["prove"]) == (name == "resume")
    assert CP.role_argvs("resume", CP.CASES["resume"])["prove"][-4:] == [
        "--checkpoint", "resume.ckpt", "--checkpoint-every", "4"]
    assert CP.case_inputs(CP.CASES["resume"])[4] == 2
    assert 64 <= len(CP.case_inputs(CP.CASES["resume"])[2]) <= 256


def test_resumed_prover_rehearsed(tmp_path):
    """The crashed prover with the CLI on the CPU: killed as its
    checkpoint appears, its counts up to the checkpoint kept, resumed
    after four folds by a second process, verified; then refused, as
    every count is 0 here, before the checkpoint as after it."""
    rec = CP.run_case("resume", str(tmp_path), device="cpu")
    assert rec["resume"]["exit_code"] == -9
    assert CP.RESUME_MIN_FOLDS <= rec["resume"]["folds_done"] < 12
    assert rec["resume"]["checkpoint_bytes"] > 0
    assert not (tmp_path / "resume.ckpt").exists()
    assert not [k for k in rec if "cmtkey" in k]
    assert set(rec["seconds"]) == {"commit", "prove", "verify"}
    assert rec["launches"] == {} and rec["resume"]["launches"] == {}
    assert CP.refusals(CP.CASES["resume"], rec) == list(CP.MSM_KERNELS) + [
        f"{k} before the checkpoint" for k in CP.MSM_KERNELS]


def test_make_refuses_a_case_with_zero_launches():
    """`make` on the CPU, the roles of `password` in processes of their
    own: its prove process launched nothing, so the case is refused."""
    with pytest.raises(CP.CaseRefused, match="msm_tree"):
        CP.make(["password"], reference=False,
                run=lambda name, work, reference: CP.run_case(
                    name, work, device="cpu"))


def test_role_runner_writes_counts_when_the_cli_fails(monkeypatch,
                                                      tmp_path):
    from reef_tpu_torch import cli
    from reef_tpu_torch.utils import cudabuild

    def failing(argv):
        assert argv == ["ascii", "--prove"]
        cudabuild.count("msm_tree")
        raise SystemExit(1)

    monkeypatch.setattr(cli, "main", failing)
    monkeypatch.setattr(cudabuild, "_COUNTS",
                        {k: 0 for k in cudabuild.KERNELS})
    counts = tmp_path / "n.json"
    with pytest.raises(SystemExit):
        CP.main(["role", str(counts), "ascii", "--prove"])
    assert CP.json.loads(counts.read_text())["msm_tree"] == 1


def test_role_runner_writes_counts_before_each_checkpoint(monkeypatch,
                                                          tmp_path):
    """The counts next to a checkpoint are those of the launches before
    it, written before the checkpoint itself appears; other files the CLI
    saves get none."""
    from reef_tpu_torch import cli
    from reef_tpu_torch.utils import cudabuild, serialize
    ckpt, proof = str(tmp_path / "p.ckpt"), str(tmp_path / "p.proof")
    seen = []

    def write(path, kind, obj):
        seen.append((kind, os.path.exists(path + CP.AT_CHECKPOINT)))
        return 0

    def proving(argv):
        cudabuild.count("msm_tree")
        serialize.save(ckpt, "ckpt", {})
        cudabuild.count("padd_reduce")
        serialize.save(proof, "proof", [])

    monkeypatch.setattr(cli, "main", proving)
    monkeypatch.setattr(serialize, "save", write)
    monkeypatch.setattr(cudabuild, "_COUNTS",
                        {k: 0 for k in cudabuild.KERNELS})
    CP.main(["role", str(tmp_path / "n.json"), "ascii", "--prove"])
    assert seen == [("ckpt", True), ("proof", False)]
    at = CP.json.loads(open(ckpt + CP.AT_CHECKPOINT).read())
    assert (at["msm_tree"], at["padd_reduce"]) == (1, 0)
    assert not os.path.exists(proof + CP.AT_CHECKPOINT)
    end = CP.json.loads((tmp_path / "n.json").read_text())
    assert (end["msm_tree"], end["padd_reduce"]) == (1, 1)


FULL = {"msm_tree": 84, "padd_reduce": 9, "poseidon_spread": 20,
        "sumcheck_coeffs": 20}


@pytest.mark.parametrize("zero", [None, *FULL])
@pytest.mark.parametrize("name", ["password", "dna"])
def test_floors_with_faked_counts(name, zero):
    """A table case needs all four kernels, another K2 and K1's reduce."""
    launches = {k: v for k, v in FULL.items() if k != zero}

    def fake(case, work, reference):
        return {"name": case, "made_by": "reef_tpu_torch", "seconds": {},
                "launches": launches, "cmt": "", "cmt_sha256":
                CP.hashlib.sha256(b"").hexdigest(), "proof": "",
                "proof_sha256": CP.hashlib.sha256(b"").hexdigest()}

    refused = zero in CP.MSM_KERNELS or (
        zero is not None and CP.CASES[name].get("table"))
    if refused:
        with pytest.raises(CP.CaseRefused, match=zero):
            CP.make([name], reference=False, run=fake)
    else:
        assert [r["name"] for r in CP.make([name], False, run=fake)] == [name]


@pytest.mark.parametrize("zero", [None, *CP.MSM_KERNELS])
def test_resume_floors_before_the_checkpoint(zero):
    """The killed prove process must have launched K2 and K1's reduce
    before its checkpoint: the folds the checkpoint holds committed on the
    card."""
    before = {k: 3 for k in CP.MSM_KERNELS if k != zero}

    def fake(case, work, reference):
        return {"name": case, "made_by": "reef_tpu_torch", "seconds": {},
                "launches": FULL, "resume": {"launches": before},
                "cmt": "", "cmt_sha256": CP.hashlib.sha256(b"").hexdigest(),
                "proof": "",
                "proof_sha256": CP.hashlib.sha256(b"").hexdigest()}

    if zero:
        with pytest.raises(CP.CaseRefused,
                           match=f"{zero} before the checkpoint"):
            CP.make(["resume"], reference=False, run=fake)
    else:
        assert CP.make(["resume"], False, run=fake)[0]["name"] == "resume"


def test_store_keeps_the_other_makers_pairs(tmp_path):
    path = str(tmp_path / "pairs.json")
    card = [{"name": n, "made_by": "reef_tpu_torch", "v": 1}
            for n in ("password", "dna")]
    ref = [{"name": "password", "made_by": "reef_tpu", "v": 1}]
    CP.store(path, "reef_tpu_torch", {"card": "x"}, card)
    CP.store(path, "reef_tpu", {"device": "cpu"}, ref)
    CP.store(path, "reef_tpu_torch", {"card": "y"},
             [{"name": "dna", "made_by": "reef_tpu_torch", "v": 2}])
    doc = CP.load(path)
    assert doc["makers"] == {"reef_tpu_torch": {"card": "y"},
                             "reef_tpu": {"device": "cpu"}}
    assert [(p["made_by"], p["name"], p["v"]) for p in doc["pairs"]] == [
        ("reef_tpu_torch", "dna", 2), ("reef_tpu", "password", 1)]
