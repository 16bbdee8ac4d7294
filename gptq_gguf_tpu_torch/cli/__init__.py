"""Command-line subcommands of the port."""
