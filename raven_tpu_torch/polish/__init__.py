"""Consensus phase driver (reference RavenLib/src/polish.cc).

A copy of raven_tpu/polish/__init__.py that threads the device into the
Polisher; each round is the span "polish.round" with its engine.
"""

from __future__ import annotations

import numpy as np

from raven_tpu_torch.config import PolishCfg
from raven_tpu_torch.graph.common import get_unitigs, unitig_record_name
from raven_tpu_torch.io.readset import reverse_complement
from raven_tpu_torch.polish.polisher import Polisher  # noqa: F401
from raven_tpu_torch.utils import trace

CIRCULAR_ROTATION = 0.42  # polish.cc:62


def polish(
    graph,
    readset,
    cfg: PolishCfg | None = None,
    checkpoints: bool = False,
    device=None,
):
    """Polish unitigs for cfg.num_rounds rounds (polish.cc:10-86) on
    `device` (CUDA unless the caller asks for the CPU).

    Stage semantics: one round per stage increment starting at 0; resuming
    mid-polish continues with the remaining rounds.  Each round is a span
    "polish.round" whose counts hold the round and its engine, "device" or
    "host" (Polisher.last_engine).
    """
    cfg = cfg or PolishCfg()
    if len(readset) == 0 or cfg.num_rounds == 0:
        return

    unitig_nodes = get_unitigs(graph)
    if not unitig_nodes:
        return

    graph.piles = None  # polish.cc:24

    # average dataset quality (polish.cc:26-41)
    avg_q = 0.0
    if readset.has_quality:
        for i in range(len(readset)):
            avg_q += readset.mean_quality(i)
        avg_q /= len(readset)
    if avg_q == 0.0:
        readset.drop_quality()

    polisher = Polisher(
        quality_threshold=avg_q,
        error_threshold=0.3,
        window_len=500,
        trim=True,
        match=cfg.align_cfg.match,
        mismatch=cfg.align_cfg.mismatch,
        gap=cfg.align_cfg.gap,
        device_cfg=cfg.device_cfg,
        device=device,
    )

    # targets: (name-with-tags, codes), parallel node list
    targets = [(unitig_record_name(n), n.codes) for n in unitig_nodes]
    nodes = list(unitig_nodes)

    while graph.stage < cfg.num_rounds:
        # hybrid schedule on accelerators: POA rounds for local accuracy,
        # the batched device voting consensus LAST — it recovers the
        # indel-driven length the POA trim gives up (lambda 2-round golden
        # config: ED 1021 vs 1137 reference raven / 1236 POA-only)
        polisher.use_device_consensus = (
            None if graph.stage == cfg.num_rounds - 1 else False
        )
        with trace.span("polish.round", round=graph.stage) as s:
            results = polisher.polish(targets, readset, include_unpolished=False)
            s["engine"] = polisher.last_engine

        new_targets = []
        new_nodes = []
        # map result -> node by the Utg/Ctg prefix of the name (polish.cc:55)
        name_to_node = {n.name: n for n in nodes}
        for name, codes in results:
            node = name_to_node.get(name.split()[0])
            if node is None:
                continue
            fraction = float(name.rsplit(":", 1)[1])
            if fraction > 0:
                if node.is_circular:  # rotate (polish.cc:60-66)
                    b = int(CIRCULAR_ROTATION * codes.size)
                    codes = np.concatenate([codes[b:], codes[:b]])
                node.is_polished = node.pair.is_polished = True
                node.codes = codes
                node.pair.codes = reverse_complement(codes)
            new_targets.append((name, codes))
            new_nodes.append(node)
        targets = new_targets
        nodes = new_nodes

        from raven_tpu_torch.utils import stagedump

        if stagedump.enabled():
            stagedump.dump(
                f"polish/round_{graph.stage}",
                n_targets=len(new_targets),
                contig_lengths=sorted(int(c.size) for _, c in new_targets),
                codes_hash=stagedump._hash_array(
                    np.concatenate([c for _, c in new_targets])
                    if new_targets
                    else np.zeros(0, np.uint8)
                ),
            )
        graph.stage += 1
        if checkpoints:
            from raven_tpu_torch.graph.binary import store_graph

            with trace.span("polish.checkpoint",
                            log="[raven_tpu_torch::Graph::Polish] reached checkpoint"):
                store_graph(graph)
