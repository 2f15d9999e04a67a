"""The turns of the chip A/B tools (``tools/paged_serve_ab.run_turns``,
which ``tools/k5_host_ab.py`` also runs): each side's worker in a process of
its own, started in that checkout, in the order other, this, this, other,
...; one JSON line a run from the worker's last marked line, and a failed
run reported with its exit code.  Runs a stand-in worker script on the
CPU."""
import json
import os
import textwrap

from tools import k5_host_ab, paged_serve_ab


def _stand_in(tmp_path, fail_in=None):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import json, os, sys
        checkout = sys.argv[sys.argv.index("--worker") + 1]
        if {fail_in!r} and checkout == {fail_in!r}:
            sys.exit(3)
        print("noise")
        print({paged_serve_ab.MARK!r} + json.dumps({{"first": 1}}))
        print({paged_serve_ab.MARK!r} + json.dumps({{"cwd": os.getcwd(), "args": sys.argv[3:]}}))
    """))
    return str(script)


def test_runs_alternate_and_read_the_last_marked_line(tmp_path, capsys):
    other = tmp_path / "other"
    other.mkdir()
    rc = paged_serve_ab.run_turns(_stand_in(tmp_path), str(other), 2, ["--configs", "a,b"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [r["side"] for r in rows] == ["other", "this", "this", "other"]
    assert [r["run"] for r in rows] == [0, 1, 2, 3]
    for r in rows:
        want = str(other) if r["side"] == "other" else paged_serve_ab.ROOT
        assert r["checkout"] == want and os.path.samefile(r["cwd"], want)
        assert r["args"] == ["--configs", "a,b"] and "first" not in r


def test_a_failed_run_is_reported_and_the_rest_still_run(tmp_path, capsys):
    other = tmp_path / "other"
    other.mkdir()
    rc = paged_serve_ab.run_turns(_stand_in(tmp_path, fail_in=str(other)), str(other), 1)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert rows[0]["side"] == "other" and rows[0]["failed"] == 3
    assert rows[1]["side"] == "this" and "failed" not in rows[1]


def test_both_tools_mark_their_result_lines_alike():
    assert k5_host_ab.MARK == paged_serve_ab.MARK
