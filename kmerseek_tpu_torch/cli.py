"""kmerseek-compatible click CLI: ``index`` and ``search`` commands
(counterpart of ``kmerseek_tpu/cli.py``).

Same subcommands, flags, defaults (moltype=hp, ksize=24, scaled=5),
filename conventions, stdout/stderr contract and ``--force`` semantics.
The sketch, the k-mer hash pass and the search cross-check run on
``--device`` (default ``cuda``; without a GPU this fails unless
``--device cpu`` is given). ``--engine auto`` and ``--engine device``
both sketch on the device; ``--engine native`` sketches with the C++ CPU
sketcher (bit-equal), and search still runs on ``--device``.
``index --profile DIR`` and ``search --profile DIR`` write a
``torch.profiler`` Chrome trace of the command into DIR, with the
program's spans as ``kmerseek/<span>`` ranges, and log the span table
(``utils.metrics``) at the end.
"""

from __future__ import annotations

import click

from .core.entity import KmerseekIndex, KmerseekQuery
from .core.search import MANYSEARCH_COLUMNS, manysearch, write_search_csv
from .utils.device import resolve_device
from .utils.logging import logger, setup_logging


def _device(device: str):
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise click.UsageError(str(e)) from None


_ENGINE = click.option(
    "--engine",
    type=click.Choice(["auto", "device", "native"]),
    default="auto",
    help="Sketch engine: 'auto' and 'device' sketch on --device, "
    "'native' with the C++ CPU sketcher (bit-equal)",
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
    from .utils.hostmem import tune_host_allocator

    tune_host_allocator()  # corpus-scale numpy: reuse arena pages


@cli.command()
@click.argument("fasta")
@click.option("--moltype", default="hp")
@click.option("--ksize", type=int, default=24)
@click.option("--scaled", type=int, default=5)
@click.option("--extract-kmers", is_flag=True, default=False)
@click.option(
    "--profile", default=None, help="Write a torch.profiler Chrome trace to this directory"
)
@_ENGINE
@_DEVICE
@click.option("--debug", is_flag=True, help="Enable debug logging")
@_FORCE
def index(fasta, moltype, ksize, scaled, extract_kmers, profile, engine, device, debug, force):
    """Index a proteome FASTA."""
    from .utils.metrics import device_profile

    setup_logging(debug)
    dev = _device(device)
    with device_profile(profile, dev):
        entity = KmerseekIndex(
            fasta, moltype=moltype, ksize=ksize, scaled=scaled, force=force,
            extract_kmers=extract_kmers, engine=engine, device=dev,
        )
        if extract_kmers:
            logger.info("K-mer extraction will be performed during indexing.")
        else:
            logger.info("K-mer extraction will be skipped during indexing.")
        _ = entity.sig
        _ = entity.ksx
        if extract_kmers:
            logger.info("K-mers stored in: %s", entity.kmers_pq)
    if profile:
        logger.info("profiler trace written to %s", profile)


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
@click.option(
    "--profile", default=None, help="Write a torch.profiler Chrome trace to this directory"
)
@click.option(
    "--annotate-domains",
    default=None,
    help="UniProt XML export (optionally .gz): log domain/region features "
    "overlapping each stitched match interval. Requires --extract-kmers",
)
@click.option(
    "--stitch-per-query",
    is_flag=True,
    default=False,
    help="Group stitched rows by (match, query) pair instead of kmerseek's "
    "match-name-only grouping. Off by default for output parity",
)
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
    profile,
    annotate_domains,
    stitch_per_query,
    engine,
    device,
    debug,
    force,
):
    """Search for k-mers in target sequences. With --extract-kmers the
    stitched CSV goes to stdout (or --output) and the report to stderr."""
    if annotate_domains and not extract_kmers:
        raise click.UsageError(
            "--annotate-domains requires --extract-kmers (domains are "
            "looked up for stitched match intervals)"
        )
    from .utils.metrics import device_profile

    setup_logging(debug)
    dev = _device(device)
    with device_profile(profile, dev):
        _search(
            query_fasta, target_fasta, output, sourmash_search_csv, annotate_domains,
            stitch_per_query, extract_kmers,
            dict(
                moltype=moltype, ksize=ksize, scaled=scaled, force=force,
                extract_kmers=extract_kmers, engine=engine, device=dev,
            ),
        )
    if profile:
        logger.info("profiler trace written to %s", profile)


def _search(
    query_fasta, target_fasta, output, sourmash_search_csv, annotate_domains,
    stitch_per_query, extract_kmers, kw,
):
    """``search`` once its options are checked (``kw``: the entities')."""
    query = KmerseekQuery(query_fasta, **kw)
    _ = query.sig
    _ = query.kmers_pq
    target = KmerseekIndex(target_fasta, **kw)
    _ = target.sig

    rows = manysearch(query.index, target.index)
    if sourmash_search_csv:
        write_search_csv(rows, MANYSEARCH_COLUMNS, sourmash_search_csv)
    if not extract_kmers:
        write_search_csv(rows, MANYSEARCH_COLUMNS, output)
        return

    # pandas is imported here: `index` and plain `search` never need it
    from .core.stitch import write_stitched

    # both sidecars stream through a name + hash-join filter, so memory
    # stays bounded by the rows that can join; the report goes to stderr
    stitched, _counts = write_stitched(
        rows, query.kmers_pq, target.kmers_pq, output, group_by_pair=stitch_per_query
    )
    if annotate_domains:
        from .core.uniprot import get_domains

        for row in stitched.itertuples():
            domains = get_domains(
                row.match_name, int(row.match_start), int(row.match_end),
                xml_path=annotate_domains,
            )
            for d in domains or ():
                logger.info(f"Found: {d.name} in {d.start}-{d.end}")


if __name__ == "__main__":
    cli()
