"""One driver for each kind of entry into the program, found by the
configuration's "entry" key: portbench/entries/<entry>.py defines Entry."""
