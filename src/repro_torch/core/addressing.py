"""SES addressing (Sec. 3.1.1): FA -> JobID -> PIDonFEP -> Resource Index
— the port of ``repro.core.addressing``.

UE addresses a logical endpoint with (FA, JobID[24b], PIDonFEP[12b], RI[12b]).
Two modes exist, selected by the `rel` header bit:

* RELATIVE — parallel jobs: the JobID table at the FEP maps the packet's
  JobID to a per-job PIDonFEP table (the job's local processes); the
  PIDonFEP table entry points at the process's RI table.
* ABSOLUTE — client/server: PIDonFEP acts like a UDP port directly into a
  service table; the JobID is carried only as an authentication token.

The lookup pipeline is vectorized gathers over fixed-capacity tables, so
a whole batch of arriving packets resolves at once. Authorization is the
JobID membership check (Sec. 3.1.1: "authorization to write to the queue
is provided by the Job ID"). A JobID held by several rows resolves to
the first of them, as the reference's ``argmax`` over the hit matrix
does.

Scalability claim: with relative addressing a source stores N node
entries and computes the target process as an offset, versus N*P direct
entries — see `directory_entries()`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.core import scatter

JOBID_BITS = 24
PIDONFEP_BITS = 12
RI_BITS = 12

INVALID = -1


@dataclass(frozen=True)
class FEPTables:
    """Fixed-capacity addressing tables of one Fabric Endpoint.

    All tensors are int32. A -1 entry means "empty".

    jobid_keys:   [J]    JobIDs that have processes on this FEP
    jobid_to_pid: [J]    row index into pid_table for each job
    pid_table:    [J_cap, P] per-job PIDonFEP -> process slot (address space id)
    ri_table:     [Proc, R]  per-process RI -> receive-context id
    service_table:[S]    absolute mode: PIDonFEP -> receive-context id
    """

    jobid_keys: torch.Tensor
    jobid_to_pid: torch.Tensor
    pid_table: torch.Tensor
    ri_table: torch.Tensor
    service_table: torch.Tensor

    @staticmethod
    def create(num_jobs: int, procs_per_job: int, ris_per_proc: int,
               num_services: int = 64, device=None) -> "FEPTables":
        dev = resolve_device(device)

        def empty(*shape):
            return torch.full(shape, INVALID, dtype=torch.int32, device=dev)
        return FEPTables(
            jobid_keys=empty(num_jobs),
            jobid_to_pid=empty(num_jobs),
            pid_table=empty(num_jobs, procs_per_job),
            ri_table=empty(num_jobs * procs_per_job, ris_per_proc),
            service_table=empty(num_services),
        )


def register_job(tables: FEPTables, slot: int, jobid: int,
                 proc_ids: torch.Tensor,
                 ri_contexts: torch.Tensor) -> FEPTables:
    """Install a job at table row `slot` (management-plane operation).

    proc_ids: [P] local process slots for PIDonFEP 0..P-1 (or -1)
    ri_contexts: [P, R] receive-context ids per process per RI

    ``slot`` follows the reference's two index rules: the row writes
    (``jobid_keys``, ``jobid_to_pid``, ``pid_table``) count a negative
    slot from the end and drop one outside [-J, J), while the RI block
    starts at row ``slot * P`` — counted from the end once if negative,
    then clamped so the block fits in the table (the reference's
    ``dynamic_update_slice``): a slot of J writes the last job's RI rows
    and no job row.
    """
    slot = int(slot)
    dev = tables.pid_table.device
    proc = torch.as_tensor(proc_ids, device=dev).to(torch.int32)
    ris = torch.as_tensor(ri_contexts, device=dev).to(torch.int32)
    num_jobs, procs = tables.pid_table.shape
    pid_table = tables.pid_table
    row = slot + num_jobs if slot < 0 else slot
    if 0 <= row < num_jobs:
        pid_table = pid_table.clone()
        pid_table[row] = proc
    rows = tables.ri_table.shape[0]
    start = slot * procs + (rows if slot < 0 else 0)
    start = min(max(start, 0), rows - ris.shape[0])
    ri_table = tables.ri_table.clone()
    ri_table[start:start + ris.shape[0], :ris.shape[1]] = ris
    return FEPTables(
        jobid_keys=scatter.set_last(tables.jobid_keys, slot, jobid),
        jobid_to_pid=scatter.set_last(tables.jobid_to_pid, slot, slot),
        pid_table=pid_table,
        ri_table=ri_table,
        service_table=tables.service_table,
    )


def resolve(tables: FEPTables, jobid: torch.Tensor, pid_on_fep: torch.Tensor,
            ri: torch.Tensor, rel: torch.Tensor):
    """Resolve a batch of arriving packets to receive-context ids.

    Args:
      jobid, pid_on_fep, ri, rel: int32 [B] header fields per packet.

    Returns:
      (ctx_id [B] int32, ok [B] bool). ctx_id == -1 where resolution or
      authorization failed (unknown JobID, out-of-range PID/RI, empty slot).
    """
    jobid = jobid.to(torch.int32)
    pid_on_fep = pid_on_fep.to(torch.int32)
    ri = ri.to(torch.int32)
    keys = tables.jobid_keys
    num_jobs = keys.shape[0]

    # --- relative mode: associative JobID match (CAM-style, vectorized) ---
    # [B, J] equality against the jobid CAM; empty rows never match. The
    # first hit wins: the least index among the hits (J where none).
    hits = (keys[None, :] == jobid[:, None]) & (keys[None, :] != INVALID)
    cols = torch.arange(num_jobs, dtype=torch.int32, device=keys.device)
    first = torch.where(hits, cols, num_jobs).amin(dim=1)
    job_ok = first < num_jobs
    job_row = torch.where(job_ok, first, 0).long()

    P = tables.pid_table.shape[1]
    R = tables.ri_table.shape[1]
    pid_ok = (pid_on_fep >= 0) & (pid_on_fep < P)
    pid_c = pid_on_fep.clamp(0, P - 1).long()
    proc = tables.pid_table[job_row, pid_c]
    proc_ok = pid_ok & (proc != INVALID)
    ri_ok = (ri >= 0) & (ri < R)
    ctx_rel = tables.ri_table[job_row * P + pid_c, ri.clamp(0, R - 1).long()]
    ok_rel = job_ok & proc_ok & ri_ok & (ctx_rel != INVALID)

    # --- absolute mode: PIDonFEP indexes the service table like a UDP port.
    S = tables.service_table.shape[0]
    svc_ok = (pid_on_fep >= 0) & (pid_on_fep < S)
    ctx_abs = tables.service_table[pid_on_fep.clamp(0, S - 1).long()]
    ok_abs = svc_ok & (ctx_abs != INVALID)

    is_rel = rel != 0
    ok = torch.where(is_rel, ok_rel, ok_abs)
    ctx = torch.where(is_rel, ctx_rel, ctx_abs)
    return torch.where(ok, ctx, INVALID), ok


def directory_entries(num_nodes: int, procs_per_node: int,
                      relative: bool) -> int:
    """Source-side directory size (Sec. 3.1.1 scalability argument).

    Direct addressing stores N*P entries; relative UE addressing stores N
    entries and computes the process as a PIDonFEP offset.
    """
    return num_nodes if relative else num_nodes * procs_per_node
