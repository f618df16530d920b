"""kmerseek-compatible click CLI: ``index`` and ``search`` commands
(counterpart of ``kmerseek_tpu/cli.py``).

Same subcommands, flags, defaults (moltype=hp, ksize=24, scaled=5),
filename conventions, stdout/stderr contract and ``--force`` semantics.
The sketch and the search cross-check run on ``--device`` (default
``cuda``; without a GPU this fails unless ``--device cpu`` is given).
``--engine auto`` and ``--engine device`` both sketch on the device.
"""

from __future__ import annotations

import click

from .core.entity import KmerseekIndex, KmerseekQuery
from .core.search import MANYSEARCH_COLUMNS, manysearch, write_search_csv
from .utils.device import resolve_device
from .utils.logging import logger, setup_logging


def _not_ported(flag: str):
    raise click.UsageError(f"{flag} is not yet ported to kmerseek_tpu_torch")


def _device(device: str):
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise click.UsageError(str(e)) from None


_ENGINE = click.option(
    "--engine",
    type=click.Choice(["auto", "device", "native"]),
    default="auto",
    help="Sketch engine: 'auto' and 'device' sketch on --device; "
    "'native' is not yet ported",
)
_DEVICE = click.option(
    "--device", default="cuda", help="torch device: cuda (default) or cpu"
)
_FORCE = click.option(
    "--force",
    is_flag=True,
    help="Force creation of signature, kmer parquet, and index even if "
    "they're already there",
)


@click.group()
def cli():
    """kmerseek: protein domain annotation search with reduced amino
    acid k-mers, on PyTorch / CUDA."""


@cli.command()
@click.argument("fasta")
@click.option("--moltype", default="hp")
@click.option("--ksize", type=int, default=24)
@click.option("--scaled", type=int, default=5)
@click.option("--extract-kmers", is_flag=True, default=False)
@click.option("--profile", default=None, help="Not yet ported")
@_ENGINE
@_DEVICE
@click.option("--debug", is_flag=True, help="Enable debug logging")
@_FORCE
def index(fasta, moltype, ksize, scaled, extract_kmers, profile, engine, device, debug, force):
    """Index a proteome FASTA."""
    if engine == "native":
        _not_ported("--engine native")
    if extract_kmers:
        _not_ported("--extract-kmers")
    if profile:
        _not_ported("--profile")
    setup_logging(debug)
    entity = KmerseekIndex(
        fasta, moltype=moltype, ksize=ksize, scaled=scaled, force=force,
        device=_device(device),
    )
    logger.info("K-mer extraction will be skipped during indexing.")
    _ = entity.sig
    _ = entity.ksx


@cli.command()
@click.argument("query_fasta")
@click.argument("target_fasta")
@click.option("--moltype", default="hp")
@click.option("--ksize", type=int, default=24)
@click.option("--scaled", type=int, default=5)
@click.option("--extract-kmers", is_flag=True, default=False)
@click.option(
    "--output", default=None, help="If not specified, then output results to stdout"
)
@click.option(
    "--sourmash-search-csv",
    default=None,
    help="Also store the manysearch results in this CSV",
)
@click.option("--annotate-domains", default=None, help="Not yet ported")
@click.option("--stitch-per-query", is_flag=True, default=False, help="Not yet ported")
@_ENGINE
@_DEVICE
@click.option("--debug", is_flag=True, help="Enable debug logging")
@_FORCE
def search(
    query_fasta,
    target_fasta,
    moltype,
    ksize,
    scaled,
    extract_kmers,
    output,
    sourmash_search_csv,
    annotate_domains,
    stitch_per_query,
    engine,
    device,
    debug,
    force,
):
    """Search for k-mers in target sequences."""
    if engine == "native":
        _not_ported("--engine native")
    if extract_kmers or stitch_per_query:
        _not_ported("--extract-kmers (stitching)")
    if annotate_domains:
        _not_ported("--annotate-domains")
    setup_logging(debug)
    dev = _device(device)
    kw = dict(moltype=moltype, ksize=ksize, scaled=scaled, force=force, device=dev)
    query = KmerseekQuery(query_fasta, **kw)
    _ = query.sig
    target = KmerseekIndex(target_fasta, **kw)
    _ = target.sig

    rows = manysearch(query.index, target.index)
    if sourmash_search_csv:
        write_search_csv(rows, MANYSEARCH_COLUMNS, sourmash_search_csv)
    write_search_csv(rows, MANYSEARCH_COLUMNS, output)


if __name__ == "__main__":
    cli()
