"""The benchmark's harness: the cell, configuration and metric files, the
run of one cell, the profile's reduction and the isolation check."""
