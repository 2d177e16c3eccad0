"""The port's multi-device dry run (parallel/dryrun.py) on eight CPU shards.

The port's counterpart of the JAX package's `dryrun_multichip`: on a mesh
of eight copies of the CPU, the sharded sumcheck on a real SAFA's table
gives the host route's transcript, the sharded MSM the native host MSM's
point, and a document proved with both sharded routes forced verifies,
in the port and, from the bytes of its `.cmt` and `.proof` files, in the
JAX package's verifier.  On the CPU every shard's point adds run in plain
torch, seconds a shard, so the e2e sends one commit (the first, of 2^15
values) to the mesh and the rest to the host MSM.
"""

import pytest
import torch

from _torch_support import (fresh_reference_terms,
                            no_compile_cache_writes,  # noqa: F401
                            one_torch_thread)
from reef_tpu.backend import framework as ref_fw
from reef_tpu.frontend import parser, regex as R
from reef_tpu.frontend.safa import SAFA
from reef_tpu.utils import serialize as ref_serialize
from reef_tpu_torch.backend import framework as port_fw
from reef_tpu_torch.parallel import mesh
from reef_tpu_torch.parallel.dryrun import default_devices, dryrun_multichip
from reef_tpu_torch.utils import device
from reef_tpu_torch.utils import serialize as port_serialize

pytestmark = pytest.mark.e2e


def test_dryrun_multichip_on_eight_cpu_shards(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(device, "_SELECTED", None)
    device.select("cpu")
    monkeypatch.setattr(mesh, "_PROCESS_MESH", None)
    verified = []
    orig = port_fw.run_verifier

    def kept(commit, safa, proofs, **kw):
        verified.append((commit, proofs))
        return orig(commit, safa, proofs, **kw)

    monkeypatch.setattr(port_fw, "run_verifier", kept)
    out = dryrun_multichip(["cpu"] * 8, msm_n=1, e2e_mesh_commits=1,
                           log=lambda msg: None)
    assert out["devices"] == ["cpu"] * 8
    assert out["sumcheck_sharded"] and out["msm_n"] == 8
    assert out["sharded_msm"] == 1 and out["sharded_rounds"] > 0
    assert mesh.process_mesh() == mesh.make_mesh()
    assert device.resolve() == torch.device("cpu")
    # the mesh-proved e2e (`.*b` over the alphabet "ab", batch 2),
    # verified by the JAX package
    (commit, proofs), = verified
    commit = ref_serialize.loads(port_serialize.dumps("cmt", commit), "cmt")
    proofs = ref_serialize.loads(port_serialize.dumps("proof", proofs),
                                 "proof")
    fresh_reference_terms()              # the verifier as a fresh process
    safa = SAFA("ab", R.simpl(parser.parse(".*b")))
    assert ref_fw.run_verifier(commit, safa, proofs, batch_size=2)


def test_dryrun_runs_on_the_card_unless_told(monkeypatch):
    """The entry point's default mesh: every CUDA device where torch sees
    several, else eight shards of cuda:0; none without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_devices() == ["cuda:0"] * 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert default_devices() == [f"cuda:{i}" for i in range(4)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_devices()
