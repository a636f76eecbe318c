"""Which host-side step of a read on one thread stalls another thread's CUDA
calls while the card is busy, on one GPU.

    python3 scripts/torch_read_stall.py

A worker stream holds a device sleep of about 150 ms ahead of an event. A
reader thread then makes one of the reads below; 10 ms later the main thread
(a serve loop) allocates 4 MiB on the card and launches a fill. A read that
stalls the main thread shows a launch of about the remaining sleep and a
reader that finishes before the main thread; one that does not shows a
launch well under a millisecond and a reader that finishes about 140 ms
after it. The reads: nothing; an event's synchronize; a fresh pinned host
allocation; a new high-priority stream, first from its pool and then pooled;
a device allocation on a pooled stream the allocator has not used; a
stream's wait on the event and synchronize; copies into a preallocated
pinned buffer on that stream (what ``engine.py::_HostMirror`` does);
``torch.stack`` then a pinned copy on a new pooled stream each time (a
first design of the cohort's health read), three times; and the same
event-ordered read into pageable memory (``.cpu()``). Prints the card's name
and power limit, one line a read and one JSON line.
"""
import json
import subprocess
import threading
import time

import torch

SLEEP_CYCLES = 300_000_000  # about 150 ms on an H100


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_read_stall: no CUDA device is available")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    worker = torch.cuda.Stream()
    rows = [torch.zeros(64, dtype=torch.int32, device=dev) for _ in range(4)]
    sizes = iter(range(1000, 100000, 777))
    side = torch.cuda.Stream(priority=-1)
    host = torch.empty((4, 64), dtype=torch.int32, pin_memory=True)
    torch.cuda.synchronize()
    results = {}

    def trial(label, read):
        ready = torch.cuda.Event()
        with torch.cuda.stream(worker):
            torch.cuda._sleep(SLEEP_CYCLES)
            ready.record()
        entered, done = threading.Event(), []

        def reader():
            entered.set()
            read(ready)
            done.append(time.perf_counter())

        th = threading.Thread(target=reader)
        th.start()
        entered.wait(10.0)
        time.sleep(0.01)
        t0 = time.perf_counter()
        torch.empty(1 << 20, device=dev).fill_(1)  # the serve loop's allocation and launch
        t1 = time.perf_counter()
        th.join(10.0)
        torch.cuda.synchronize()
        results[label] = {"launch_ms": (t1 - t0) * 1e3, "reader_done_after_ms": (done[0] - t1) * 1e3}
        print(f"{label:44s} launch {results[label]['launch_ms']:8.3f} ms, reader done"
              f" {results[label]['reader_done_after_ms']:+8.1f} ms after it")

    def device_alloc_on_pooled_stream(ready):
        with torch.cuda.stream(torch.cuda.Stream(priority=-1)):
            torch.empty(next(sizes), device=dev)

    def wait_and_sync(ready):
        side.wait_event(ready)
        side.synchronize()

    def preallocated_mirror(ready):
        side.wait_event(ready)
        with torch.cuda.stream(side):
            for row, t in zip(host, rows):
                row.copy_(t, non_blocking=True)
        side.synchronize()

    def stack_then_pinned(ready):
        s = torch.cuda.Stream(priority=-1)
        s.wait_event(ready)
        with torch.cuda.stream(s):
            stacked = torch.stack(rows)
            out = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            out.copy_(stacked, non_blocking=True)
        s.synchronize()

    def pageable(ready):
        side.wait_event(ready)
        with torch.cuda.stream(side):
            torch.stack([t.cpu() for t in rows])

    trial("nothing", lambda ready: None)
    trial("event.synchronize", lambda ready: ready.synchronize())
    trial("fresh pinned allocation", lambda ready: torch.empty(next(sizes), dtype=torch.int32, pin_memory=True))
    trial("new high-priority stream (first)", lambda ready: torch.cuda.Stream(priority=-1))
    trial("new high-priority stream (pooled)", lambda ready: torch.cuda.Stream(priority=-1))
    trial("device allocation on a pooled stream", device_alloc_on_pooled_stream)
    trial("stream wait_event + synchronize", wait_and_sync)
    trial("preallocated pinned mirror", preallocated_mirror)
    for i in range(1, 4):
        trial(f"stack + pinned copy on a new stream {i}", stack_then_pinned)
    trial("pageable .cpu() after the event", pageable)
    print(json.dumps({"card": card, "read_stall": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
