"""Host control-plane demo: message strobes, the message debug sink, a rate
probe and the packet credit loop (port of examples/messages.py; the
reference's messages.cpp / done_msg_sink.cpp / packet_strobe.cpp). Runs on
the host; ``--device`` is taken and checked like every example's.

usage: python -m gr4_packet_modem_tpu_torch.examples.messages [--device DEV]
"""

from __future__ import annotations

import time

from ..runtime.flow import PacketCredit, ProbeRate, Throttle
from ..runtime.messages import ItemStrobe, MessageDebug, MessageStrobe, PacketStrobe
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the strobe messages ``stored``, the items ``pulled``, the
    rate ``reports`` as ``(rate_now, rate_avg)``, the items ``sent`` and
    the credit loop's final ``in_flight``."""
    parse(argv, "messages")
    # MessageStrobe -> MessageDebug.store (message_strobe.hpp -> message_debug.hpp)
    debug = MessageDebug()
    strobe = MessageStrobe(debug.store, {"lifecycle": "ping"}, interval=0.05).start()
    time.sleep(0.22)
    strobe.stop()
    stored = len(debug.messages())
    echo(f"MessageDebug stored {stored} strobe messages")

    # ItemStrobe pull mode: one item per interval (item_strobe.hpp)
    items = ItemStrobe(item=42, interval=0.02)
    t0 = time.time()
    pulled = [items.next_item() for _ in range(5)]
    echo(f"ItemStrobe pulled {pulled} in {time.time() - t0:.2f}s")

    # PacketStrobe -> throttled sink with a rate probe (packet_strobe.hpp,
    # probe_rate.hpp, throttle.hpp)
    probe = ProbeRate(alpha=0.15)
    throttle = Throttle(rate=200_000.0)
    strobe = PacketStrobe(packet_length=256, interval=0.01)
    sent, reports = 0, []
    for _ in range(20):
        pkt = strobe.next_packet()
        throttle.wait(pkt.size)
        rep = probe.update(pkt.size)
        if rep:
            reports.append((rep.rate_now, rep.rate_avg))
            echo(f"rate_now={rep.rate_now:,.0f} items/s rate_avg={rep.rate_avg:,.0f}")
        sent += pkt.size
    echo(f"sent {sent} items")

    # latency credit loop: at most 2 packets in flight (tun_source.hpp:69-78)
    credit = PacketCredit(max_packets=2)
    in_flight = []
    for i in range(4):
        check(credit.acquire(timeout=0.1) or credit.in_flight < 2, "credit refused below 2 in flight")
        in_flight.append(i)
        if len(in_flight) == 2:  # downstream consumes
            credit.release(2)
            in_flight.clear()
    echo(f"credit loop done, in_flight = {credit.in_flight}")
    return {"stored": stored, "pulled": pulled, "reports": reports, "sent": sent,
            "in_flight": credit.in_flight}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
