"""A mesh rank's batches (``data/loader.py``): ``data_block`` keeps data
position d's block of every tier's rows, so the ranks' blocks, tier by
tier, are the global batch; ``batch_slice`` builds only a rank's rows of
the global stream and refuses length tiers, as the JAX package's loader
does; the tier caps round up so that they divide over a data axis."""

import numpy as np
import pytest

import _torch_mesh_worker as W
from sessionrec_tpu_torch.data.loader import BatchLoader
from sessionrec_tpu_torch.graph.batch import flatten_blocks


def _leaves(batch):
    out = []
    for b in flatten_blocks(batch):
        for f in ("node_iid", "node_mask", "mail_idx", "sc_adj", "labels",
                  "valid", "last_idx"):
            out.append(np.asarray(getattr(b, f)))
    return out


@pytest.mark.parametrize("dp", [2, 4])
def test_data_blocks_join_into_the_global_batch(dp):
    sessions, _, _ = W.train_data()
    kw = dict(split_len=(4, 8), prefetch=0)
    whole = next(iter(BatchLoader(sessions, "lessr", 64, 20, **kw)))
    blocks = [next(iter(BatchLoader(sessions, "lessr", 64, 20,
                                    data_block=(d, dp), **kw)))
              for d in range(dp)]
    for i, leaf in enumerate(_leaves(whole)):
        parts = [_leaves(b)[i] for b in blocks]
        assert all(len(p) == len(leaf) // dp for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts), leaf)


def test_batch_slice_builds_a_ranks_rows_and_refuses_tiers():
    sessions, _, _ = W.train_data()
    whole = next(iter(BatchLoader(sessions, "session", 64, 20, prefetch=0)))
    part = next(iter(BatchLoader(sessions, "session", 64, 20, prefetch=0,
                                 batch_slice=(32, 64))))
    np.testing.assert_array_equal(part.labels, whole.labels[32:64])
    np.testing.assert_array_equal(part.node_iid, whole.node_iid[32:64])
    with pytest.raises(ValueError, match="batch_slice"):
        BatchLoader(sessions, "session", 64, 20, split_len=(4, 8),
                    batch_slice=(0, 32))


def test_tier_caps_divide_over_a_data_axis():
    sessions, _, _ = W.train_data()
    caps = BatchLoader(sessions, "ccs", 64, 20, split_len=(4, 8)).split[1]
    assert all(c % 32 == 0 for c in caps)
    with pytest.raises(ValueError, match="does not divide"):
        next(iter(BatchLoader(sessions, "ccs", 60, 20, prefetch=0,
                              data_block=(0, 8))))
