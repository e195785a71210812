"""A guided tour of the UET transport layers (Sec. 3) on the PyTorch port:
addressing -> matching -> large-message protocols -> PDC lifecycle, each
exercised with the port's vectorized implementations
(``repro_torch.core``). It walks the same steps as
``examples/uet_transport_tour.py`` (the JAX package's tour) and prints
the same lines.

``tour(device)`` returns every value the tour prints, as plain Python
values; ``main()`` prints them. The tensors live on ``cuda`` unless
``--device cpu`` is given (there is no CPU fallback).

Run: PYTHONPATH=src python examples/uet_transport_tour_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import addressing, matching, messaging, pdc
from repro_torch.core.types import MsgProtocol, Profile
from repro_torch.network.profile import DeliveryMode, TransportProfile


def tour(device=None) -> dict:
    """Walk the tour's steps on ``device``; returns the printed values."""
    dev = resolve_device(device)
    out = {}

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    out["profiles"] = [prof.describe() for prof in (
        TransportProfile.ai_base(), TransportProfile.ai_full(),
        TransportProfile.hpc())]

    # [SES] relative addressing (Sec 3.1.1)
    t = addressing.FEPTables.create(num_jobs=4, procs_per_job=8,
                                    ris_per_proc=4, device=dev)
    ris = torch.arange(32, dtype=torch.int32, device=dev).reshape(8, 4) + 100
    t = addressing.register_job(
        t, 1, jobid=0x2313,
        proc_ids=torch.arange(8, dtype=torch.int32, device=dev),
        ri_contexts=ris)
    ctx, ok = addressing.resolve(t, jobid=i32([0x2313, 0xBAD]),
                                 pid_on_fep=i32([2, 2]), ri=i32([1, 1]),
                                 rel=i32([1, 1]))
    out["addr_ctx"] = ctx.tolist()
    out["addr_ok"] = ok.tolist()
    out["directory_relative"] = addressing.directory_entries(10000, 1000,
                                                             True)
    out["directory_direct"] = addressing.directory_entries(10000, 1000,
                                                           False)

    # [SES] tag matching (Sec 3.1.2)
    q = matching.RecvQueue.create(8, device=dev)
    hi, lo = matching.encode_match_key(comm_id=7, tag=42, msg_seq=0)
    q = matching.post_receive(q, 0, hi, lo, 0, 0, matching.ANY_INITIATOR,
                              seq=0, buffer_id=5)
    slot, ok = matching.match(q, i32([hi]), i32([lo]), i32([3]),
                              Profile.AI_FULL)
    out["exact_slot"] = int(slot[0])
    out["exact_matched"] = bool(ok[0])
    mh, ml = matching.wildcard_mask(match_tag=False, match_seq=False)
    q2 = matching.RecvQueue.create(8, device=dev)
    bh, bl = matching.encode_match_key(7, 0, 0)
    q2 = matching.post_receive(q2, 0, bh, bl, mh, ml,
                               matching.ANY_INITIATOR, 0, 6)
    th, tl = matching.encode_match_key(7, 999, 4)
    slot, ok = matching.match(q2, i32([th]), i32([tl]), i32([3]),
                              Profile.HPC)
    out["wildcard_matched"] = bool(ok[0])

    # [SES] large-message protocols (Sec 3.1.3, Fig 5)
    link = messaging.LinkModel(alpha=1.0, beta=0.01)
    out["protocol_names"] = [proto.name for proto in MsgProtocol]
    out["protocol_expected"] = [messaging.simulate_protocol(
        proto, 1000, 5.0, 2.0, link, eager_limit=2000).receiver_complete
        for proto in MsgProtocol]
    out["protocol_unexpected"] = [messaging.simulate_protocol(
        proto, 1000, 2.0, 12.0, link, eager_limit=2000).receiver_complete
        for proto in MsgProtocol]

    # [PDS] PDC lifecycle, Fig 6
    pool = pdc.PDCPool.create(2, device=dev)
    pool = pdc.open_pdc(pool, 0, 7, 4, mode=int(DeliveryMode.ROD))
    out["pdc_open_state"] = pdc.PDCState(int(pool.state[0])).name
    out["pdc_mode"] = DeliveryMode(int(pool.mode[0])).name
    pool = pdc.on_ack(pool, 0, 19, 1)
    out["pdc_ack_state"] = pdc.PDCState(int(pool.state[0])).name
    out["pdc_remote_id"] = int(pool.remote_id[0])
    st = pool.state[:1]
    events = (pdc.InitEvent.CLOSE_REQ, pdc.InitEvent.DRAINED,
              pdc.InitEvent.CLOSE_ACK)
    out["pdc_close_events"] = [ev.name for ev in events]
    out["pdc_close_states"] = []
    for ev in events:
        st = pdc.step_initiator(st, i32([int(ev)]))
        out["pdc_close_states"].append(pdc.PDCState(int(st[0])).name)
    return out


def lines(v: dict) -> "list[str]":
    """The tour's printed lines, from ``tour``'s values."""
    out = ["=== [profiles] declarative transport compositions (Sec 2.2) ==="]
    out += [f"  {d}" for d in v["profiles"]]
    out.append("=== [SES] relative addressing (Sec 3.1.1) ===")
    out.append(f"  JobID 0x2313/PID 2/RI 1 -> ctx {v['addr_ctx'][0]} "
               f"(ok={v['addr_ok'][0]})")
    out.append(f"  unknown JobID           -> ctx {v['addr_ctx'][1]} "
               f"(authorization is the JobID)")
    out.append(f"  directory: relative {v['directory_relative']:,}"
               f" entries vs direct {v['directory_direct']:,}")
    out.append("\n=== [SES] tag matching (Sec 3.1.2) ===")
    out.append(f"  exact match (AI Full): slot {v['exact_slot']}, "
               f"matched={v['exact_matched']}")
    out.append(f"  wildcard ANY_TAG (HPC): matched={v['wildcard_matched']}")
    out.append("\n=== [SES] large-message protocols (Sec 3.1.3, Fig 5) ===")
    out.append(f"  {'protocol':22s} {'expected':>9s} {'unexpected':>10s}")
    for name, te, tu in zip(v["protocol_names"], v["protocol_expected"],
                            v["protocol_unexpected"]):
        out.append(f"  {name:22s} {te:9.2f} {tu:10.2f}")
    out.append("\n=== [PDS] PDC lifecycle, Fig 6 ===")
    out.append(f"  after first send : state={v['pdc_open_state']}"
               f" (sending at FULL RATE during establishment; one PDC per "
               f"delivery mode — this one is {v['pdc_mode']})")
    out.append(f"  after first ACK  : state={v['pdc_ack_state']},"
               f" remote PDCID={v['pdc_remote_id']}")
    for ev, st in zip(v["pdc_close_events"], v["pdc_close_states"]):
        out.append(f"  {ev:10s}       -> {st}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    for ln in lines(tour(args.device)):
        print(ln)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
