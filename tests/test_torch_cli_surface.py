"""The port's CLI covers the JAX CLI: every command, nested ones included,
and every option of each.

Walks both argparse trees (``build_parser``) and holds the port's to JAX's:
the same command paths both ways, and each JAX option present on the same
command of the port. The intended differences are listed here and nowhere
else: JAX's global ``--platform`` has no port (the commands take
``--device``), ``pipeline --task-platform`` is ``--task-device``, and the
port adds ``--device`` to the commands that run on a device and ``train``'s
profiler window flags.
"""

import argparse

from dss_ml_at_scale_tpu.config import cli as jax_cli
from dss_ml_at_scale_tpu_torch.config import cli as port_cli

JAX_ONLY = {(): {"--platform"}, ("pipeline",): {"--task-platform"}}
PORT_ONLY = {
    **{(c,): {"--device"} for c in ("audit", "bench", "chaos", "eda", "export", "forecast",
                                    "hpo", "lm", "predict", "sanitize", "serve", "serve-lm")},
    ("datagen", "demand"): {"--device"},
    ("pipeline",): {"--task-device"},
    ("train",): {"--device", "--profile-num-steps", "--profile-start-step"},
}


def _commands(parser, prefix=()) -> dict:
    out = {prefix: parser}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_commands(sub, prefix + (name,)))
    return out


def _options(parser) -> set[str]:
    return {o for a in parser._actions for o in a.option_strings}


def test_every_jax_command_has_a_port_counterpart():
    theirs = _commands(jax_cli.build_parser())
    ours = _commands(port_cli.build_parser())
    assert set(theirs) == set(ours)
    assert ("bench", "profile") in ours and ("info",) in ours and len(ours) > 40


def test_options_differ_only_where_intended():
    theirs = _commands(jax_cli.build_parser())
    ours = _commands(port_cli.build_parser())
    jax_only = {k: _options(theirs[k]) - _options(ours[k]) for k in theirs}
    port_only = {k: _options(ours[k]) - _options(theirs[k]) for k in theirs}
    assert {k: v for k, v in jax_only.items() if v} == JAX_ONLY
    assert {k: v for k, v in port_only.items() if v} == PORT_ONLY
