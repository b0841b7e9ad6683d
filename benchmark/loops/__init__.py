"""One module a traffic kind (a traffic file's ``kind``): ``run(cell)``
drives the program through set-up, the measured window and the check."""
