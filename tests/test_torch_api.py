"""The port's library API (recgraph_tpu_torch.api) on the CPU against
recgraph_tpu.api: records equal field for field and byte for byte.

recgraph_tpu's API runs the non-walk engine and the Python emitter; the
port's runs the CLI's walk engine and native emitter, so these tests
also show that the two paths give the same record."""

import dataclasses

import pytest
import torch

from recgraph_tpu import api as jax_api
from recgraph_tpu.io import fasta as jax_fasta
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu_torch import api
from recgraph_tpu_torch.io import gfa

torch.set_num_threads(1)

READS = (0, 17, 44)   # example reads: the first, and two others


@pytest.fixture(scope="module")
def example(example_paths):
    seqs, names = jax_fasta.get_sequences(example_paths[0])
    return ([s[1:] for s in seqs], names, jax_gfa.parse_gfa(example_paths[1]),
            gfa.parse_gfa(example_paths[1]))


def _same(ref, got):
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.to_string() == ref.to_string()


@pytest.mark.parametrize("fn", ["align_global_no_gap", "align_local_no_gap",
                                "align_global_gap", "align_local_gap"])
def test_align_matches_jax(example, fn):
    reads, names, jg, tg = example
    for i in READS:
        ref = getattr(jax_api, fn)(reads[i], jg, names[i])
        got = getattr(api, fn)(reads[i], tg, names[i], device="cpu")
        _same(ref, got)
        assert got.query_name == names[i] and got.path


def test_score_matrices_match_jax():
    for m, x in ((2, -4), (1, -1), (5, -3)):
        assert (api.create_score_matrix_i32(m, x).table
                == jax_api.create_score_matrix_i32(m, x).table).all()
        assert (api.create_score_matrix_f32(float(m), float(x)).table
                == jax_api.create_score_matrix_f32(float(m), float(x)).table).all()
        assert (api.create_score_matrix_f32(float(m), float(x)).table
                == api.create_score_matrix_i32(m, x).table).all()


def test_explicit_arguments_match_jax(example):
    reads, names, jg, tg = example
    read = reads[5][:60] + reads[5][90:]          # a deletion against the graph
    sm = (jax_api.create_score_matrix_i32(1, -1), api.create_score_matrix_i32(1, -1))
    cases = [("align_global_no_gap", dict(bases_to_add=0.0)),
             ("align_global_gap", dict(o=-2, e=-2)),
             ("align_local_gap", dict(o=-1, e=-1))]
    for fn, kw in cases:
        ref = getattr(jax_api, fn)(read, jg, "r", sm[0], **kw)
        _same(ref, getattr(api, fn)(read, tg, "r", sm[1], device="cpu", **kw))
        # the arguments change the record, so the port did not ignore them
        assert ref.to_string() != getattr(jax_api, fn)(read, jg, "r", sm[0]).to_string()


def test_default_device_needs_cuda(example, monkeypatch):
    reads, names, _, tg = example
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in ("align_global_no_gap", "align_local_no_gap", "align_global_gap",
               "align_local_gap"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            getattr(api, fn)(reads[0], tg, names[0])
