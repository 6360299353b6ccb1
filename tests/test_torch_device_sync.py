"""The port's host-device sync auditor (pinot_tpu_torch.analysis.device_sync,
W013 / W014) on torch: a true positive and a clean negative for each sink
class, the fence allowlist, vmapped bodies, taint through returns, the
live tree against its baseline, and `audit_sites`' verdicts."""
import json
import textwrap
from pathlib import Path

import pytest

from pinot_tpu_torch.analysis import device_sync
from pinot_tpu_torch.analysis.device_sync import DeviceSyncPass, audit_sites
from pinot_tpu_torch.analysis.engine import Project, load_baseline, run_passes

ROOT = Path(__file__).resolve().parents[1]


def _findings(src, warm=("warm.py",), allowed=None, **extra):
    files = {"pkg/warm.py": textwrap.dedent(src)}
    for name, body in extra.items():
        files[f"pkg/{name}.py"] = textwrap.dedent(body)
    proj = Project.from_sources(files)
    pass_ = DeviceSyncPass(warm_suffixes=warm, allowed_syncs=allowed if allowed is not None else set())
    return run_passes(proj, [pass_])


def _rules(src, **kw):
    return [f.rule for f in _findings(src, **kw)]


# each sink class: (true positive, clean negative)
SINKS = {
    "float_int_bool": (
        """
        import torch

        def total(x, dev):
            t = torch.as_tensor(x, device=dev)
            return float(t.sum()), int(t.max()), bool(t.any())
        """,
        """
        import torch

        def total(x, dev):
            t = torch.as_tensor(x, device=dev).cpu()  # the explicit drain
            return float(t.sum()), int(t.max()), bool(t.any())
        """,
    ),
    "item_tolist_numpy": (
        """
        import torch

        def rows(codes, dev):
            t = codes.to(dev)
            return t.sum().item(), t.tolist(), t.numpy()
        """,
        """
        import torch

        def rows(codes, dev):
            t = codes.to(dev)
            host = t.to("cpu")
            return host.sum().item(), host.tolist(), host.numpy()
        """,
    ),
    "np_on_device": (
        """
        import numpy as np
        import torch

        def home(n, dev):
            return np.asarray(torch.arange(n, device=dev))
        """,
        """
        import numpy as np
        import torch

        def home(n, dev):
            return np.asarray(torch.arange(n))  # a host tensor: no device given
        """,
    ),
    "cuda_synchronize": (
        """
        import torch

        def fence():
            torch.cuda.synchronize()
        """,
        """
        import torch

        def fence(out):
            return out
        """,
    ),
    "event_stream_synchronize": (
        """
        def wait(ev, stream):
            ev.synchronize()
            stream.synchronize()
        """,
        """
        def wait(ev, stream):
            ev.record(stream)
            return ev.query()
        """,
    ),
    "nonzero": (
        """
        import torch

        def ids(mask):
            return torch.nonzero(mask).reshape(-1)
        """,
        """
        import torch

        def ids(mask):
            return torch.where(mask, 1, 0)  # fixed shape
        """,
    ),
    "masked_select": (
        """
        import torch

        def pick(x, m):
            return torch.masked_select(x, m)
        """,
        """
        import torch

        def pick(x, m):
            return torch.where(m, x, torch.zeros_like(x))
        """,
    ),
    "boolean_mask_indexing": (
        """
        import torch

        def pick(n, dev):
            x = torch.arange(n, device=dev)
            keep = x > 3
            return x[keep], x[x % 2 == 0]
        """,
        """
        import torch

        def pick(n, dev):
            x = torch.arange(n, device=dev)
            idx = torch.argsort(x)
            return x[idx], x[:4]  # an index gather and a slice: fixed shapes
        """,
    ),
    "unique": (
        """
        import torch

        def keys(k):
            return torch.unique(k)
        """,
        """
        import torch

        def keys(k):
            return torch.sort(k).values
        """,
    ),
    "repeat_interleave": (
        """
        import torch

        def expand(x, r):
            return torch.repeat_interleave(x, r)
        """,
        """
        import torch

        def expand(x, r, total):
            return torch.repeat_interleave(x, r, output_size=total)
        """,
    ),
    "method_forms_on_device_values": (
        """
        import torch

        def run(n, dev):
            t = torch.arange(n, device=dev)
            return t.nonzero(), t.unique(), t.repeat_interleave(2)
        """,
        """
        import numpy as np

        def run(a):
            h = np.asarray(a)
            return h.nonzero(), np.unique(h)  # numpy: host
        """,
    ),
}


@pytest.mark.parametrize("sink", sorted(SINKS))
def test_sink_true_positive(sink):
    assert "W013" in _rules(SINKS[sink][0])


@pytest.mark.parametrize("sink", sorted(SINKS))
def test_sink_clean_negative(sink):
    assert _rules(SINKS[sink][1]) == []


def test_branch_on_device_value_is_w014():
    src = """
    import torch

    def run(n, dev):
        t = torch.arange(n, device=dev)
        if t.any():
            return 1
        while t.sum() > 0:
            t = t - 1
        return 0
    """
    assert [r for r in _rules(src) if r == "W014"] == ["W014", "W014"]


def test_branch_on_host_copy_or_none_check_is_clean():
    src = """
    import torch

    def run(n, dev, opt):
        t = torch.arange(n, device=dev)
        if opt is None:
            return None
        h = t.cpu()
        if h.any():
            return 1
        if t.shape[0] > 2 and t.dtype == torch.int64:
            return 2
        return 0
    """
    assert _rules(src) == []


def test_allowlist_admits_the_sanctioned_fence():
    src = """
    class ServerInstance:
        def _device_wait(self, end):
            end.synchronize()

        def execute(self, end):
            end.synchronize()
    """
    files = {"pkg/cluster/server.py": textwrap.dedent(src)}
    proj = Project.from_sources(files)
    found = run_passes(proj, [DeviceSyncPass()])
    assert [(f.rule, f.symbol) for f in found] == [("W013", "ServerInstance.execute")]


def test_default_allowlist_names_device_wait():
    assert device_sync.ALLOWED_SYNCS == {("cluster/server.py", "ServerInstance._device_wait")}
    assert device_sync.WARM_PATH_SUFFIXES == ("parallel/engine.py", "query/reduce.py", "cluster/server.py")


def test_vmapped_bodies_are_excluded():
    src = """
    import torch

    def body(x):
        return int(x.sum().item())

    @torch.func.vmap
    def other(x):
        torch.cuda.synchronize()
        return x

    fb = torch.func.vmap(body)
    """
    assert _rules(src) == []


def test_taint_flows_through_returns():
    src = """
    import torch

    def scan(n, dev):
        return torch.arange(n, device=dev)

    def collect(n, dev):
        out = scan(n, dev)
        return out.tolist()
    """
    assert _rules(src) == ["W013"]


def test_taint_flows_through_cross_module_returns():
    src = """
    from pkg.kernels import launch

    def collect(x):
        return int(launch(x))
    """
    kernels = """
    import torch

    def launch(x):
        return torch.cumsum(x, 0)
    """
    assert _rules(src, kernels=kernels) == ["W013"]


def test_kernel_wrappers_are_sources():
    src = """
    from pkg.ops.fused_scan import fused_group_tables

    def collect(entries, codes, g):
        out = fused_group_tables(entries, codes, g)
        return out[0].tolist()
    """
    assert _rules(src, ops__fused_scan="def fused_group_tables(e, c, g):\n    return e\n") == ["W013"]


def test_taint_does_not_flow_through_parameters():
    src = """
    def collect(out):
        return out.tolist()  # a device value handed down: the pass's known gap
    """
    assert _rules(src) == []


def test_off_the_warm_path_is_quiet():
    src = """
    import torch

    def f(n, dev):
        return torch.arange(n, device=dev).tolist()
    """
    proj = Project.from_sources({"pkg/coldpath.py": textwrap.dedent(src)})
    assert run_passes(proj, [DeviceSyncPass(warm_suffixes=("warm.py",), allowed_syncs=set())]) == []


def test_live_tree_findings_are_all_baselined():
    found = run_passes(Project.from_tree(), [DeviceSyncPass()])
    entries = [e for e in load_baseline() if e["rule"] in ("W013", "W014")]
    assert found, "the warm path has syncs the baseline names"
    for f in found:
        assert any(f.path.endswith(e["path"]) and e["symbol"] == f.symbol for e in entries), str(f)


def test_audit_sites_verdicts(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "cluster").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "cluster" / "server.py").write_text(textwrap.dedent(
        """
        import torch


        class ServerInstance:
            def _device_wait(self, end):
                end.synchronize()

            def execute(self, x):
                torch.cuda.synchronize()
                torch.cuda.synchronize()  # pinot-lint: disable=W013
                a = torch.nonzero(x)
                b = x.cpu()
                return x.tolist()
        """
    ))
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [
        {"rule": "W013", "path": "pkg/cluster/server.py", "line": 12, "justification": "t"}]}))
    rel = "pkg/cluster/server.py"
    lines = (7, 10, 11, 12, 13, 14)
    got = audit_sites([(rel, ln) for ln in lines], root=str(pkg), baseline_path=str(base))
    assert [got[(rel, ln)]["verdict"] for ln in lines] == [
        device_sync.FENCE, device_sync.FINDING, device_sync.INLINE, device_sync.BASELINE, device_sync.DRAIN,
        device_sync.NOTHING]
    assert got[(rel, 14)]["symbol"] == "ServerInstance.execute"


def test_audit_sites_on_the_port_tree():
    rel = "pinot_tpu_torch/cluster/server.py"
    src = (ROOT / rel).read_text().splitlines()
    line = next(i for i, s in enumerate(src, 1) if "end.synchronize()" in s)
    got = audit_sites([(rel, line)])
    assert got[(rel, line)]["verdict"] == device_sync.FENCE
