"""Document packing: concatenate variable-length documents into fixed-length
rows with loss-masking of the padding remainder (labels = IGNORE). A copy of
``src/repro/data/packing.py`` (numpy only) with the port's ``IGNORE``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.training.loss import IGNORE


def pack_documents(docs: List[np.ndarray], seq: int,
                   pad_token: int = 0) -> Dict[str, np.ndarray]:
    """docs: list of 1-D int arrays. Returns {"tokens": [N,seq], "labels": [N,seq]}.
    Documents are packed greedily; a document never spans two rows' loss
    boundary (labels crossing a document edge are masked)."""
    rows, labels, cur, cur_l = [], [], [], []
    for doc in docs:
        doc = np.asarray(doc, np.int32)
        i = 0
        while i < len(doc):
            space = seq + 1 - len(cur)
            take = min(space, len(doc) - i)
            chunk = doc[i:i + take]
            cur.extend(chunk.tolist())
            cur_l.extend(chunk.tolist())
            if i + take < len(doc) or take == space:
                pass
            i += take
            if len(cur) == seq + 1:
                rows.append(cur[:seq])
                labels.append(cur_l[1:seq + 1])
                cur, cur_l = [], []
        if cur:  # mask the boundary between documents
            cur_l[-1] = IGNORE if cur_l else IGNORE
    if cur:
        pad = seq + 1 - len(cur)
        tok_row = cur + [pad_token] * pad
        lab_row = cur_l[1:] + [IGNORE] * (seq + 1 - len(cur_l))
        rows.append(tok_row[:seq])
        labels.append((lab_row + [IGNORE] * seq)[:seq])
    tokens = np.asarray(rows, np.int32)
    labs = np.asarray(labels, np.int32)
    return {"tokens": tokens, "labels": labs}
