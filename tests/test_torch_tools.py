"""The port's measurement tools, on the parts that need no card."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from puppax_torch.tools.profile_unroll import device_busy_us


def _ev(start, end, device=DeviceType.CUDA):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=device)


@pytest.mark.parametrize("spans, busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),            # disjoint
    ([(0, 10), (5, 12), (11, 30)], 30.0),  # overlapping chain
    ([(20, 25), (0, 10), (2, 3)], 15.0),   # unsorted, nested
])
def test_device_busy_is_the_union_of_device_intervals(spans, busy):
    events = [_ev(a, b) for a, b in spans] + [_ev(0, 100, DeviceType.CPU)]
    assert device_busy_us(events) == busy
