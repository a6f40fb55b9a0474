"""repro_torch.serve — the continuous-batching serving layer (port of
`repro.serve`; reference DESIGN.md §11).

Module map:

  coalescer.py — hazard-ordered request->tape-chunk folding (adjacent
                 same-kind ops merge; stream order is preserved, which
                 is what makes serving bitwise-equal to sequential
                 per-op execution) + result scatter
  server.py    — `Server` (submit/pump/drain/warm/stats), the adaptive
                 time/size `WindowPolicy`, the maintenance `Governor`,
                 replication roles and quorum-held acks, and per-client
                 latency accounting
  frontend.py  — `AsyncServer`, the asyncio ``await submit(...)`` facade
  loadgen.py   — closed-loop multi-client driver + SLO helper

The data plane is the engine's mixed-op tape (`repro_torch.engine.tape`):
one coalescing window runs as one `run_tape` call on the engine's device,
whose slot results come to the host in one blocking device-to-host read a
tape segment — never one a request.
"""
from repro_torch.serve.coalescer import (OP_OF, Placement,  # noqa: F401
                                         coalesce, scatter)
from repro_torch.serve.frontend import AsyncServer  # noqa: F401
from repro_torch.serve.loadgen import (Request, closed_loop,  # noqa: F401
                                       sustained_at_slo)
from repro_torch.serve.server import (Governor, QuorumAckError,  # noqa: F401
                                      Server, Ticket, WindowPolicy)
