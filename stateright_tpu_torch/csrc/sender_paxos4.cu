// The sender kernel of sender_paxos.cu for single-decree paxos at 4 clients, a
// translation unit of its own so that it builds beside the other client
// counts: the same entry point (sr_sender_paxos), which returns
// cudaErrorInvalidValue at any other client count. stateright_tpu_torch/
// wave.py loads it for 4 clients (SPLIT_SOURCES).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --split-compile=0
//        -shared -Xcompiler -fPIC (stateright_tpu_torch/_build.py).

#define SR_PAXOS_LO 4
#define SR_PAXOS_HI 4
#include "sender_paxos.cu"
