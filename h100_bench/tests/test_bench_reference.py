"""The plain reference receiver decodes a small bank on the CPU, and its
rows agree with the program's (whose kernels run their plain versions on
CPU tensors)."""

import json

import numpy as np
import torch

from h100_bench import correct, traffic
from h100_bench.reference.receiver import ReferenceReceiver

from .conftest import BENCH


def _bank(seed, cfg, channels=2, block=1 << 16):
    mix = json.loads((BENCH / "traffic" / "dense1500_64ch.json").read_text())
    mix.update(pool=3)
    dev = torch.device("cpu")
    pool = traffic.make_pool(seed, mix, dev)
    lay = traffic.make_layout(traffic.rng_for(seed, 2), channels, block, pool, mix["cfo"])
    ref = ReferenceReceiver(cfg, dev)
    fp = ref.front_pad
    x = torch.zeros(channels, fp + block + ref.pad_tail(), dtype=torch.complex64)
    x[:, fp : fp + block] = traffic.synthesize(lay, pool, block, mix["noise"], traffic.torch_generator(seed, dev))
    truth = [[(fp + s, p, w) for s, p, w in row] for row in traffic.truth(lay, pool, block)]
    return ref, x, truth, pool


def test_reference_decodes_every_packet_and_matches_the_program():
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig

    torch.set_num_threads(4)
    cfg = json.loads((BENCH / "configs" / "rx_vv.json").read_text())["rx"]
    cfg["max_detections"] = 8
    ref, x, truth, pool = _bank(11, cfg)
    want = ref.decode(x)
    packets = [(c, int(want["index"][c, j]), want["data"][c, j, : int(want["length"][c, j])])
               for c in range(2) for j in np.nonzero(want["accepted"][c])[0]]
    m = correct.match_truth(packets, truth, pool.payloads)
    assert m["expected"] >= 4 and m["missed"] == m["false"] == m["dup"] == 0
    rx = Receiver(RxConfig(**cfg), "cpu")
    det, hdr, res, keep = rx.bank_step(x, 0)
    t = {"index": det.index, "valid": det.valid, "esn0_db": det.esn0_db, "header_ok": hdr.header_ok,
         "length": hdr.packet_length, "packet_type": hdr.packet_type, "keep": keep,
         "crc_ok": res.crc_ok, "accepted": res.accepted}
    rows = {k: v.numpy().reshape(2, 8) for k, v in t.items()}
    rows["data"] = res.data.numpy().reshape(2, 8, -1)
    r = correct.compare_rows(rows, want)
    assert r["det_diff"] == 0 and r["row_diff"] == 0 and r["esn0_gap_db"] < 1e-3
