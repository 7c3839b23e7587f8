"""The port's hybrid and chains documents run through both engines, the
JAX package's (``repro.core``, unchanged) and the port's
(``repro_torch.core``), on the CPU at the test sizes, under
``data_locality`` and ``round_robin``: the same document, the same bodies
(``repro_torch.pipeline`` with ``device: cpu``), the same seed.

Compared, because runs of the JAX engine alone give them the same every
time, eight test processes at once on eight cores included: the outputs'
bits (summary, stats, clusters), the multiset of (step, status, attempt)
events, the invocations per step, the site each step kind ran on, and the
transfers (count and bytes) of the kinds ``two-step`` and ``collect`` per
(source site, target site) link.

Not compared, because they change from run to run of the JAX engine
alone: the replica each invocation ran on, and with it the ``elided``,
``intra-model`` and ``direct`` transfers.  Which replica of a site takes an
invocation depends on which worker thread finished first; a token already
on that replica is elided, one on a sibling replica moves within the
site, and a shard may cross the occam-garr_cloud link to one or two cloud
replicas (6, 7 or 8 direct transfers in those runs).  Wall times are not
compared.
"""
import collections

import pytest

import repro.core as J
import repro_torch.core as T
from test_torch_engine import chains_doc, events_of, hybrid_doc, run_doc, \
    same_outputs

STABLE_KINDS = ("two-step", "collect")


def _site(name):
    return None if name is None else name.split(":")[0]


def accounting(ex, res) -> dict:
    """What a run did that does not depend on thread timing."""
    links = collections.Counter()
    for t in res.transfers:
        if t.kind in STABLE_KINDS:
            links[(t.kind, _site(t.src), _site(t.dst), "n")] += 1
            links[(t.kind, _site(t.src), _site(t.dst), "bytes")] += t.bytes
    summary = ex.data.transfer_summary()
    return {
        "events": events_of(res),
        "invocations": collections.Counter(
            e.step.split("@")[0] for e in res.events),
        "sites": collections.Counter(
            (e.step.split("@")[0], e.model) for e in res.events),
        "links": links,
        "kinds": {k: (summary[k]["n"], summary[k]["bytes"])
                  for k in STABLE_KINDS if k in summary},
    }


DOCS = {"hybrid": hybrid_doc, "chains": chains_doc}


@pytest.mark.parametrize("policy", ["data_locality", "round_robin"])
@pytest.mark.parametrize("which", sorted(DOCS))
def test_both_engines_run_the_document_the_same(which, policy):
    doc = DOCS[which](policy)
    jex, jres = run_doc(J, doc)
    tex, tres = run_doc(T, doc)
    same_outputs(tres.outputs, jres.outputs)
    assert accounting(tex, tres) == accounting(jex, jres)
    assert {e.status for e in tres.events} == {"completed"}
    assert not any(e.speculative for e in tres.events)
    if which == "hybrid":
        want = {"two-step": (1, 5)}         # the seed, over management
        assert {k: v for k, v in accounting(tex, tres)["kinds"].items()
                if k == "two-step"} == want
        # each sample's count ran on one of the two sites and its model
        # reached the cloud's seurat
        assert accounting(tex, tres)["invocations"]["/count"] == \
            tres.outputs["summary"]["n_samples"]
