"""Forge client of the port: package, publish and fetch trained models.

Counterpart of ``veles/forge_client.py``, with the same package format,
name checks, version order and verbs, so either client lists and fetches
the other's packages. The store is a directory (local disk or a mount).

A package is ``<name>-<version>.forge.tar.gz`` holding ``metadata.json``
(name, version, workflow, description, files, created) and the artifacts
the caller listed: checkpoints, inference archive directories
(``contents.json`` + ``.npy``), config files. The port's checkpoints and
archives are the reference's formats, so a package of either package's
artifacts loads in both.

    python -m veles_torch.forge_client [--store DIR] upload NAME FILE...
                                       [--version V] [--description D]
    python -m veles_torch.forge_client [--store DIR] fetch NAME DEST
                                       [--version V]
    python -m veles_torch.forge_client [--store DIR] list

The store defaults to ``root.common.dirs.forge``.
"""

import argparse
import io
import json
import os
import re
import sys
import tarfile
import time

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _check_token(value, what):
    """Names and versions become path components: keep them to a safe
    set of characters so no argument escapes the store directory."""
    value = str(value)
    if not _NAME_RE.match(value) or value.startswith("."):
        raise ValueError(
            "invalid %s %r: use letters, digits, '.', '_', '-'"
            % (what, value))
    return value


def _version_key(version):
    """Numeric-aware order: '10' > '9'; dotted versions and time stamps
    compare piece by piece."""
    return tuple((0, int(p)) if p.isdigit() else (1, p)
                 for p in str(version).split("."))


def _store_dir(store=None):
    from veles_torch.config import root
    store = store or root.common.dirs.forge
    os.makedirs(store, exist_ok=True)
    return store


def _package_path(store, name, version):
    return os.path.join(store, "%s-%s.forge.tar.gz" % (name, version))


def upload(name, files, store=None, version=None, workflow=None,
           description=""):
    """Package ``files`` (paths, or (arcname, path) pairs; a directory
    goes in whole) into the store; -> the package's path."""
    store = _store_dir(store)
    name = _check_token(name, "package name")
    version = _check_token(
        version or time.strftime("%Y%m%d%H%M%S"), "version")
    entries = []
    for f in files:
        arc, path = f if isinstance(f, tuple) else (os.path.basename(f), f)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        entries.append((arc, path))
    meta = {
        "name": name, "version": version,
        "workflow": workflow or name, "description": description,
        "files": [arc for arc, _ in entries],
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    out = _package_path(store, name, version)
    with tarfile.open(out, "w:gz") as tar:
        blob = json.dumps(meta, indent=1).encode()
        info = tarfile.TarInfo("metadata.json")
        info.size = len(blob)
        info.mtime = int(time.time())
        tar.addfile(info, io.BytesIO(blob))
        for arc, path in entries:
            tar.add(path, arcname=arc)
    return out


def list_packages(store=None):
    """[{name, version, workflow, description, files, created, package}]
    of the store's readable packages, by file name."""
    store = _store_dir(store)
    out = []
    for fname in sorted(os.listdir(store)):
        if not fname.endswith(".forge.tar.gz"):
            continue
        path = os.path.join(store, fname)
        try:
            with tarfile.open(path, "r:gz") as tar:
                meta = json.load(tar.extractfile("metadata.json"))
        except (KeyError, tarfile.TarError, json.JSONDecodeError):
            continue
        meta["package"] = path
        out.append(meta)
    return out


def fetch(name, dest, store=None, version=None):
    """Extract the newest (or the given) version of ``name`` into
    ``dest``; -> its metadata."""
    store = _store_dir(store)
    candidates = [m for m in list_packages(store) if m["name"] == name
                  and (version is None or m["version"] == str(version))]
    if not candidates:
        raise FileNotFoundError(
            "no package %r%s in %s" % (
                name, "" if version is None else " v%s" % version, store))
    meta = max(candidates, key=lambda m: _version_key(m["version"]))
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(meta["package"], "r:gz") as tar:
        # the 'data' filter refuses path traversal, links out of dest,
        # device nodes and the like from an untrusted package
        tar.extractall(dest, filter="data")
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m veles_torch.forge_client",
                                description="Package, publish and fetch "
                                            "trained models")
    p.add_argument("--store", default=None,
                   help="store directory (default root.common.dirs.forge)")
    sub = p.add_subparsers(dest="verb", required=True)
    up = sub.add_parser("upload")
    up.add_argument("name")
    up.add_argument("files", nargs="+")
    up.add_argument("--version", default=None)
    up.add_argument("--description", default="")
    fe = sub.add_parser("fetch")
    fe.add_argument("name")
    fe.add_argument("dest")
    fe.add_argument("--version", default=None)
    sub.add_parser("list")
    args = p.parse_args(argv)
    if args.verb == "upload":
        print(upload(args.name, args.files, store=args.store,
                     version=args.version, description=args.description))
    elif args.verb == "fetch":
        print(json.dumps(fetch(args.name, args.dest, store=args.store,
                               version=args.version)))
    else:
        for m in list_packages(args.store):
            print("%-24s %-16s %s" % (m["name"], m["version"],
                                      m["description"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
