"""The program's training paths as the harness drives them, one module a
configuration ``kind``: set-up, the step, the seed's weights, the
reference's steps and the analytic operations and bytes."""
