"""The dense model family of the port (``repro.models`` for ``dense``)."""
