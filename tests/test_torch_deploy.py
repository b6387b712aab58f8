"""The port's deployment files (``deploy/torch/``), as ``tests/test_deploy.py``
holds the JAX package's: the manifests parse; every ``--flag`` a manifest
passes exists in the port CLI it names, and the manifest's whole argv is
accepted by that CLI's parser; the ``-m`` modules import; the actors'
``--connect`` names the learner's Service and port; the actors get a unique
seed source; the learner asks for a GPU where the reference asks for a TPU
slice and passes the reference's flags; and the Dockerfile copies
``dotaclient_tpu_torch/``, builds the native codec and installs no JAX."""

import argparse
import importlib
import importlib.util
import os
import re

import pytest

yaml = pytest.importorskip("yaml")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K8S = os.path.join(ROOT, "deploy", "torch", "k8s")
REF_K8S = os.path.join(ROOT, "deploy", "k8s")
CLI_SOURCES = {
    "dotaclient_tpu_torch.train.learner": "dotaclient_tpu_torch/train/learner.py",
    "dotaclient_tpu_torch.actor": "dotaclient_tpu_torch/actor/__main__.py",
}
CLI_MAINS = {"dotaclient_tpu_torch.train.learner": "dotaclient_tpu_torch.train.learner",
             "dotaclient_tpu_torch.actor": "dotaclient_tpu_torch.actor.__main__"}


def load_docs(name, where=K8S):
    with open(os.path.join(where, name)) as f:
        return [d for d in yaml.safe_load_all(f) if d is not None]


def container_specs(doc):
    if doc.get("kind") != "Deployment":
        return []
    return doc["spec"]["template"]["spec"]["containers"]


def split_module_and_flags(args):
    assert args[0] == "-m", args
    return args[1], [a.split("=", 1)[0] for a in args[2:] if a.startswith("--")]


def argparse_flags_of(rel_path):
    return set(re.findall(r'"(--[a-z0-9-]+)"', open(os.path.join(ROOT, rel_path)).read()))


def deployments(where=K8S):
    return {c["name"]: c for name in sorted(os.listdir(where)) for d in load_docs(name, where)
            for c in container_specs(d) if "args" in c}


def test_yaml_parses():
    assert sorted(os.listdir(K8S)) == ["actors.yaml", "learner.yaml", "rabbitmq.yaml"]
    for name in os.listdir(K8S):
        assert load_docs(name), name


def test_manifest_flags_exist_in_cli():
    checked = 0
    for c in deployments().values():
        module, flags = split_module_and_flags(c["args"])
        assert module in CLI_SOURCES, module
        known = argparse_flags_of(CLI_SOURCES[module])
        for fl in flags:
            assert fl in known, f"{module} does not accept {fl}"
            checked += 1
    assert checked >= 9


class Parsed(Exception):
    pass


@pytest.mark.parametrize("container", ["learner", "actor"])
def test_manifest_argv_parses_with_the_cli(container, monkeypatch):
    """The whole argv through the module's own parser (an unknown flag or a
    bad value fails), stopped before anything runs."""
    module, _ = split_module_and_flags(deployments()[container]["args"])
    mod = importlib.import_module(CLI_MAINS[module])

    def parse_args(self, args=None, namespace=None):
        ns, extras = argparse.ArgumentParser.parse_known_args(self, args, namespace)
        assert not extras
        raise Parsed(ns)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Parsed) as caught:
        mod.main(deployments()[container]["args"][2:])
    ns = caught.value.args[0]
    if container == "learner":
        assert ns.actor == "external" and ns.transport == "socket" and ns.device is None   # the card
    else:
        assert ns.platform == "cpu" and ns.connect == "dota-learner:7777"


def test_flags_are_the_references():
    """Each container passes the reference manifest's flags to the port's
    module of the same role; the CPU actor adds ``--platform=cpu``."""
    ref, port = deployments(REF_K8S), deployments()
    assert set(ref) == set(port) == {"learner", "actor"}
    for name in ref:
        rmod, rflags = ref[name]["args"][1], ref[name]["args"][2:]
        pmod, pflags = port[name]["args"][1], port[name]["args"][2:]
        assert pmod == rmod.replace("dotaclient_tpu.", "dotaclient_tpu_torch.", 1)
        assert pflags == rflags + (["--platform=cpu"] if name == "actor" else [])


def test_learner_asks_for_a_gpu():
    (dep,) = [d for d in load_docs("learner.yaml") if d.get("kind") == "Deployment"]
    spec = dep["spec"]["template"]["spec"]
    (c,) = spec["containers"]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"} == c["resources"]["requests"]
    assert not any("tpu" in k for k in spec["nodeSelector"]) and "google.com/tpu" not in str(c["resources"])
    assert dep["spec"]["strategy"] == {"type": "Recreate"}


def test_entry_modules_importable():
    for module in CLI_SOURCES:
        assert importlib.util.find_spec(module) is not None, module


def test_actor_connects_to_learner_service():
    services = {d["metadata"]["name"]: d for d in load_docs("learner.yaml") if d.get("kind") == "Service"}
    (actor,) = [c for d in load_docs("actors.yaml") for c in container_specs(d)]
    connect = [a for a in actor["args"] if a.startswith("--connect=")]
    assert connect
    host, port = connect[0].split("=", 1)[1].rsplit(":", 1)
    assert host in services
    assert int(port) in [p["port"] for p in services[host]["spec"]["ports"]]
    (learner,) = [c for d in load_docs("learner.yaml") for c in container_specs(d)]
    assert learner["ports"][0]["containerPort"] == int(port)
    assert services[host]["spec"]["selector"] == {"app": "dota-learner"}


def test_actor_pods_get_unique_seed_source():
    (actor,) = [c for d in load_docs("actors.yaml") for c in container_specs(d)]
    assert "POD_NAME" in {e["name"] for e in actor.get("env", [])}


def test_rabbitmq_is_the_references():
    assert load_docs("rabbitmq.yaml") == load_docs("rabbitmq.yaml", REF_K8S)


def test_dockerfile_copies_the_port_and_installs_no_jax():
    with open(os.path.join(ROOT, "deploy", "torch", "Dockerfile")) as f:
        lines = [line.strip() for line in f if line.strip() and not line.lstrip().startswith("#")]
    text = "\n".join(lines)
    assert "COPY dotaclient_tpu_torch/ dotaclient_tpu_torch/" in lines
    assert not re.search(r"COPY\s+dotaclient_tpu/", text) and not re.search(r"\bjax|flax|optax|orbax", text)
    assert "torch==" in text and re.search(r"^FROM nvidia/cuda:\S+-devel", text, re.M)
    assert "python -m dotaclient_tpu_torch.native.build" in text
    assert 'CMD ["-m", "dotaclient_tpu_torch.train.learner", "--help"]' in lines
    assert importlib.util.find_spec("dotaclient_tpu_torch.native.build") is not None
