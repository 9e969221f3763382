"""One module a traffic entry: ``traffic/<mix>.json`` names it as ``entry``."""
