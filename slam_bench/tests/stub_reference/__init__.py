"""A reference package for the harness's tests: `slam_bench.reference`'s
frame step under another name, with one number of its own, as a
configuration's "reference" key names it (`"tests.stub_reference"`)."""

from __future__ import annotations


def numbers(p_out, p_post, r_out, r_post) -> dict:
    """`stub_pose_tz`: the gap of the pose's z translation (m)."""
    tz = float(p_out.pose.t[2]) - float(r_out.pose.t[2])
    return {"stub_pose_tz": abs(tz)}
