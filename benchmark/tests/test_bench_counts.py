"""The analytic counts against hand counts at tiny shapes."""

from counts import model, xent

CFG = {"model": {"embedding_dim": 2, "order": 1, "num_layers": 1,
                 "extra": False, "fusion": False, "norm": True},
       "catalog": {"num_items": 10}, "data": {"max_len": 4},
       "dtype": "float32"}


def test_level_sizes():
    assert model.level_sizes([5, 6, 5, 6, 7], 3) == [3, 3, 3]
    assert model.level_sizes([5], 3) == [1, 1, 1]
    assert model.level_sizes([1, 2], 3) == [2, 1, 1]


def test_order_one_step_by_hand():
    # d 2, 8 heads: hd 16.  Session [1, 2]: n1 = 2 nodes.
    # GAT within level 1: fc 2*2*2*16 = 128, logits 2*(2+2)*16 = 128,
    # aggregation 2*2*2*16 = 128 -> 384; two convs -> 768.
    # readout: fc_u 2*2*2*2 = 16, fc_v 8, fc_e + pooling 4*2*2 = 16,
    # fc_sr 4*2*2 = 16 -> 56.  Forward 824, loss 2*10*2 = 40,
    # table norms 40: 3 * (824 + 40 + 40) = 2712.
    assert model.step_flops(CFG, [[1, 2]]) == 2712


def test_order_two_expander_and_inter():
    cfg = {**CFG, "model": {**CFG["model"], "order": 2, "fusion": True,
                            "extra": True}}
    d, hd = 2, 16
    # session [1, 2]: n1 = 2, n2 = 1 (one 2-gram)
    gru = 2 * 12 * d * d * 1
    g11 = 2 * 2 * d * hd + 2 * 4 * hd + 2 * 4 * hd
    g21 = 2 * 3 * d * hd + 2 * 3 * hd + 2 * 2 * hd     # 1 source, 2 dest
    g22 = 2 * 1 * d * hd + 2 * 2 * hd + 2 * 1 * hd
    g12 = 2 * 3 * d * hd + 2 * 3 * hd + 2 * 2 * hd
    layer = 2 * g11 + 2 * g21 + 2 * g22 + 2 * g12
    readout = 2 * (2 * 3 * d * d + 2 * d * d + 4 * 3 * d + 4 * d * d)
    gate = 2 * (2 * d * d + 4 * d)
    fwd = gru + layer + readout + gate + 2 * 2 * 10 * d + 2 * 10 * d
    assert model.step_flops(cfg, [[1, 2]]) == 3 * fwd


def test_k1_k2_by_hand():
    # 4 rows, 10 items, width 2, float32
    assert xent.k1(4, 10, 2) == (2 * 4 * 10 * 2 + 2 * 10 * 2,
                                 (4 * 2 + 10 * 2) * 4 + 4 * 4 + 2 * 4 * 4)
    ops, nbytes = xent.k2(4, 10, 2)
    assert ops == 6 * 4 * 10 * 2 + 40
    assert nbytes == (4 * 2 + 20 * 2) * 4 + 12 * 4 + 4 * 2 * 4


def test_k3_k4_by_hand():
    ops, nbytes = xent.k3(4, 3, 10, 2, 5)
    assert ops == 2 * 3 * 4 * 10 * 2 + 2 * 10 * 2
    assert nbytes == (3 * 4 * 2 + 10 * 2) * 4 + 4 * 4 + 4 * 5 * 4 \
        + 5 * 3 * 4 * 4
    ops, _ = xent.k4(4, 3, 10, 2, 5)
    assert ops == 6 * 3 * 4 * 10 * 2 + 40


def test_least_time_is_the_larger_bound():
    peaks = {"hbm_bytes_per_s": 100.0, "flops_per_s": {"float32": 10.0}}
    assert xent.least_seconds(50, 100, peaks=peaks) == 5.0
    assert xent.least_seconds(5, 1000, peaks=peaks) == 10.0


def test_loss_bound_picks_the_head():
    plain = xent.step_loss_seconds(CFG, 4)
    want = sum(xent.least_seconds(*f(4, 10, 2)) for f in (xent.k1, xent.k2))
    assert plain == want
    multi = {**CFG, "model": {**CFG["model"], "order": 3, "extra": True,
                              "fusion": True}}
    want = xent.least_seconds(*xent.k3(4, 3, 10, 2, 4)) \
        + xent.least_seconds(*xent.k4(4, 3, 10, 2, 4))
    assert xent.step_loss_seconds(multi, 4) == want
