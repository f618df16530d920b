"""``python -m kmerseek_tpu_torch`` — CLI entry."""
from .cli import cli

cli()
