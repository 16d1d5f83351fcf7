"""repro_torch.serve — serving on the card.

    solver_service   SolverService: validation, grouping by plan
                     fingerprint, padded batched dispatch, error
                     isolation and the retry ladder
    async_server     AsyncSolverServer: continuous batching with bounded
                     queues, deadline and linger flushes
    faultinject      fault-laced request streams and the contract check
    serve_step       the transformer substrate's prefill, decode and
                     greedy loop
"""
