"""A frozen copy of the fabric engine's plain path, in plain PyTorch.

It is the port's engine (``repro_torch.network.fabric`` and what it
reads: topology and routing tables, profiles and policies, PSN tracking,
faults, INC, the link layer, telemetry) as it stood when the benchmark
was written, with every kernel site taking its plain version
(``kops``, over ``kernel_ref``) on every device, and without the split
of the scenario axis over several cards. It imports neither JAX, nor
the JAX package, nor anything of the port, and builds its own topology
and routing tables, so it shares no code and no table with the program
it judges. Later changes to the program do not reach it.

Module map (reference <- port): ``fabric``, ``faults``, ``profile``,
``ecmp``, ``topology``, ``telemetry`` <- ``network.*``; ``pds``, ``inc``,
``link``, ``scatter`` <- ``core.*``; ``uet_types`` <- ``core.types``;
``nscc``, ``rccc`` <- ``core.cms.*``; ``schemes`` <- ``core.lb.schemes``;
``u32`` <- ``_u32``; ``kernel_ref`` <- ``kernels.ref``; ``kops`` <- the
CPU branch of ``kernels.ops``; ``pdc`` <- ``core.pdc.unreachable``.
"""
