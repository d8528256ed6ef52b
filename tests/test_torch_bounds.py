"""Bounded waits for the port's tests, and tests of them.

Every wait in a `tests/test_torch_*.py` file has a bound of its own, and a
test that reaches it fails instead of holding its pytest-xdist worker:

  * `ChildOutput` reads a child's output through a reader thread and a
    queue, so its deadline holds while the child prints nothing (a bare
    `readline` blocks until the next line); its `finish` waits for the
    child's exit, and at their bound both kill the child and fail with its
    last lines;
  * `stop_server` shuts an HTTP server down from a helper thread and
    requires that it, the serving thread and the micro-batcher's worker
    end within their bounds (`shutdown` alone waits for ever on a server
    whose loop never ran);
  * `bounded_list` consumes an iterator (a data loader) in a helper thread
    and fails if it does not end in time;
  * `module_deadline`, imported by every port test module (autouse, once
    per module), is the backstop for waits inside a call that cannot be
    interrupted (a program run in-process, a ctypes call into an emulated
    kernel): past MODULE_BOUND_S the module's process dumps every thread's
    stack to the run's stderr and exits, so xdist reports the running test
    as failed and replaces the worker.
"""

import faulthandler
import queue
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

# A port test module's longest run on the CPU is about a minute (the
# programs of tests/test_torch_cli.py); ten times that under a busy box
MODULE_BOUND_S = 600


def _stderr_fd(config) -> int:
    """The run's own stderr (pytest's faulthandler plugin keeps a copy of
    it; fd 2 is the capture file while a test runs)."""
    try:
        from _pytest.faulthandler import fault_handler_stderr_fd_key
        return config.stash[fault_handler_stderr_fd_key]
    except (ImportError, KeyError):
        return sys.__stderr__.fileno()


@pytest.fixture(scope="module", autouse=True)
def module_deadline(request):
    faulthandler.dump_traceback_later(MODULE_BOUND_S, exit=True,
                                      file=_stderr_fd(request.config))
    yield
    faulthandler.cancel_dump_traceback_later()


class ChildOutput:
    """The stdout (text mode, stderr merged into it) of a child process,
    read line by line by a thread into a queue, so that every wait on it
    has a deadline that holds while the child prints nothing (a bare
    `readline` blocks until the next line). `lines` holds what was read."""

    def __init__(self, proc):
        self.proc, self.lines = proc, []
        self._q = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self._q.put(line)
        self._q.put(None)

    def until(self, text: str, seconds: float) -> bool:
        """Read up to and including the first line that contains `text`,
        for at most `seconds`; whether it came."""
        deadline = time.monotonic() + seconds
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            try:
                line = self._q.get(timeout=left)
            except queue.Empty:
                return False
            if line is None:
                return False
            self.lines.append(line)
            if text in line:
                return True

    def finish(self, seconds: float) -> str:
        """Wait at most `seconds` for the child to exit and its output to
        end: the whole output. At the bound the child is killed and the
        test fails with its last lines."""
        try:
            self.proc.wait(timeout=seconds)
            self._reader.join(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        while True:
            try:
                line = self._q.get_nowait()
            except queue.Empty:
                break
            if line is not None:
                self.lines.append(line)
        if self.proc.poll() is None or self._reader.is_alive():
            self.abandon(f"the child did not end within {seconds} s")
        return "".join(self.lines)

    def abandon(self, what: str) -> None:
        """Kill the child and fail the test with `what` and its last
        lines."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        pytest.fail(f"{what}; the child's last lines:\n"
                    f"{''.join(self.lines[-30:])}")


def stop_server(httpd, serving_thread, seconds: float = 30) -> None:
    """Shut the server down and require every thread it ran to end in
    time: the serve_forever loop, the shutdown call itself and, where the
    server has one, the micro-batcher's worker."""
    stopper = threading.Thread(target=httpd.shutdown, daemon=True)
    stopper.start()
    stopper.join(timeout=seconds)
    httpd.server_close()
    batcher = getattr(httpd, "batcher", None)
    if batcher is not None:
        batcher.stop()
        batcher.worker.join(timeout=seconds)
    serving_thread.join(timeout=seconds)
    alive = [name for name, t in (
        ("shutdown", stopper), ("serve_forever", serving_thread),
        ("batcher", batcher.worker if batcher is not None else None))
        if t is not None and t.is_alive()]
    assert not alive, f"server threads still running after {seconds} s: " \
                      f"{alive}"


def bounded_list(make_iter, seconds: float = 120):
    """list(make_iter()) run in a helper thread: its items, or a failed
    test if it neither ends nor raises within `seconds` (an exception in
    it is raised here)."""
    box = {}

    def run():
        try:
            box["items"] = list(make_iter())
        except BaseException as e:      # noqa: BLE001 - re-raised below
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=seconds)
    if th.is_alive():
        pytest.fail(f"the iterator did not end within {seconds} s")
    if "error" in box:
        raise box["error"]
    return box["items"]


# ---------------------------------------------------------------------------
# the helpers' own tests
# ---------------------------------------------------------------------------

def _child(code):
    return subprocess.Popen([sys.executable, "-u", "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def test_child_output_returns_at_its_bound_while_the_child_is_silent():
    out = ChildOutput(_child("import time\nprint('started')\n"
                             "time.sleep(120)\n"))
    t0 = time.monotonic()
    assert not out.until("never printed", 2.0)
    assert out.lines == ["started\n"] and time.monotonic() - t0 < 10
    with pytest.raises(pytest.fail.Exception, match="started"):
        out.abandon("no line said 'never printed'")
    assert out.proc.poll() is not None


def test_child_output_until_then_finish_collects_the_whole_output():
    out = ChildOutput(_child("for i in range(5):\n    print('line', i)\n"))
    assert out.until("line 2", 30) and out.lines[-1] == "line 2\n"
    assert out.finish(30) == "".join(f"line {i}\n" for i in range(5))
    assert out.proc.returncode == 0


def test_finish_kills_a_child_that_does_not_exit():
    out = ChildOutput(_child("import time\nprint('up')\ntime.sleep(120)\n"))
    assert out.until("up", 30)
    with pytest.raises(pytest.fail.Exception, match="did not end"):
        out.finish(1.0)
    assert out.proc.poll() is not None


def test_stop_server_ends_its_threads():
    class Ok(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Ok)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    import urllib.request
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.status == 200
    stop_server(httpd, th)
    assert not th.is_alive()


def test_bounded_list_fails_an_iterator_that_hangs():
    release = threading.Event()

    def hangs():
        yield 1
        release.wait(60)

    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="did not end"):
        bounded_list(hangs, seconds=1.0)
    assert time.monotonic() - t0 < 10
    release.set()
    assert bounded_list(lambda: iter(range(3)), seconds=30) == [0, 1, 2]
    with pytest.raises(ValueError, match="bad item"):
        bounded_list(lambda: (int(x) for x in ("1", "bad item")),
                     seconds=30)
