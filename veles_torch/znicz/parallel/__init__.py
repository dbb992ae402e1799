"""Single-program pieces of the reference's ``veles/znicz_tpu/parallel``
package (``pipeline.py``'s block and stack math). Multi-device
parallelism is ROADMAP Queue 1 item 10b."""
