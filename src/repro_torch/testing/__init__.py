"""Test support of the port: the crash-consistency matrix
(``testing.crashmatrix``)."""
