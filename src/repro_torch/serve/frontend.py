"""Asyncio front-end: ``await submit(...)`` over the batching server
(port of `repro.serve.frontend`).

`AsyncServer` wraps a `server.Server` in an event loop: clients are
coroutines that await their requests; a single pump task drives the
coalescing windows. Because the engine is a host-driven device program,
all actual work still happens synchronously inside `Server.pump` — the
front-end's job is purely to let many logical clients interleave their
submissions onto one window stream, which is what makes the windows
worth coalescing in the first place.

Usage::

    async with AsyncServer(Server(tree)) as srv:
        vals, found = await srv.submit("alice", "lookup", keys)

The context manager starts the pump task on entry and drains on exit.
Each submit parks the ticket's result in an `asyncio.Future` the pump
resolves when the ticket's window executes.

Replication rides the same pump task: the server's idle pumps drive
the engine's replication endpoint, so an
``AsyncServer`` over a follower keeps applying the leader's stream
between client reads with no extra machinery, and one over a leader
keeps shipping. A follower server (``Server(tree, role="follower")``)
rejects write submits at intake; route writes to the leader.

Self-healing needs no front-end changes either: under
quorum acks an awaited write simply resolves later — the pump holds its
ticket until k followers confirm the bytes and resolves the future on
release — and the ``role`` property is live, flipping when the wrapped
engine auto-promotes on lease expiry or fences after being deposed. If
the ack becomes impossible (deposition, quorum timeout, drain), the
held future is *rejected* with `repro_torch.serve.QuorumAckError`, so the
awaiting client raises instead of hanging forever.
"""
from __future__ import annotations

import asyncio
from typing import Any

from repro_torch.serve.server import Server


class AsyncServer:
    """Awaitable facade over a `Server` (see module docstring)."""

    def __init__(self, server: Server, poll_s: float = 1e-4):
        self.server = server
        self.poll_s = poll_s
        self._task: asyncio.Task | None = None
        self._stop = False

    @property
    def role(self) -> str:
        """The wrapped server's replication role (leader/follower)."""
        return self.server.role

    async def submit(self, client: str, kind: str, keys,
                     vals=None) -> Any:
        """Submit one tagged request and await its result (None for
        insert/delete, the driver-call tuples for lookup/range)."""
        ticket = self.server.submit(client, kind, keys, vals)
        ticket.future = asyncio.get_running_loop().create_future()
        return await ticket.future

    async def _run(self) -> None:
        """The pump task: serve windows as the policy fires them; sleep
        a poll tick when nothing was served (the server's idle pump
        spends the governor's idle allowance on those ticks)."""
        while not self._stop:
            served = self.server.pump()
            if served == 0:
                await asyncio.sleep(self.poll_s)

    async def start(self) -> "AsyncServer":
        """Start the pump task (idempotent)."""
        if self._task is None:
            self._stop = False
            self._task = asyncio.create_task(self._run())
        return self

    async def stop(self) -> None:
        """Serve every pending request, stop the pump task, and drain
        the engine's maintenance backlog."""
        self._stop = True
        if self._task is not None:
            await self._task
            self._task = None
        self.server.drain()

    async def __aenter__(self) -> "AsyncServer":
        """Context entry: start the pump task."""
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        """Context exit: stop and drain."""
        await self.stop()
