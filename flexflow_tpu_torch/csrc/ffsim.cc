// ffsim — native strategy-search engine.
//
// TPU-native analog of the reference's C++ search runtime: the event-driven
// task-graph simulator (Simulator::simulate_runtime, simulator.cc:822) and
// the MCMC annealing loop (FFModel::mcmc_optimize, model.cc:3285). Python
// prices each (node, candidate-view) pair once with the analytic TPU cost
// model; this engine owns the hot loops — strategy evaluation, proposal/
// accept annealing, and a two-channel (compute/ICI) list-scheduling
// simulation — so search budgets scale to thousands of iterations.
//
// Exposed as a flat C API consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Edge {
  int src;
  int dst;
  // xfer[ku * n_views(dst) + kv] — resharding time between view choices
  std::vector<double> xfer;
};

struct SimGraph {
  int n_nodes = 0;
  // per node, per view
  std::vector<std::vector<double>> compute;  // fwd(+bwd) time
  std::vector<std::vector<double>> comm;     // node-attributable collective
  std::vector<std::vector<double>> sync;     // gradient all-reduce
  std::vector<std::vector<double>> memory;   // per-chip bytes
  std::vector<Edge> edges;
  std::vector<std::vector<int>> out_edges;  // node -> edge indices
  std::vector<std::vector<int>> in_edges;
};

int views_of(const SimGraph* g, int node) {
  return static_cast<int>(g->compute[node].size());
}

}  // namespace

extern "C" {

SimGraph* ffsim_create(int n_nodes) {
  auto* g = new SimGraph();
  g->n_nodes = n_nodes;
  g->compute.resize(n_nodes);
  g->comm.resize(n_nodes);
  g->sync.resize(n_nodes);
  g->memory.resize(n_nodes);
  g->out_edges.resize(n_nodes);
  g->in_edges.resize(n_nodes);
  return g;
}

void ffsim_destroy(SimGraph* g) { delete g; }

void ffsim_set_node(SimGraph* g, int node, int n_views, const double* compute,
                    const double* comm, const double* sync,
                    const double* memory) {
  g->compute[node].assign(compute, compute + n_views);
  g->comm[node].assign(comm, comm + n_views);
  g->sync[node].assign(sync, sync + n_views);
  g->memory[node].assign(memory, memory + n_views);
}

void ffsim_add_edge(SimGraph* g, int src, int dst, const double* xfer) {
  Edge e;
  e.src = src;
  e.dst = dst;
  e.xfer.assign(xfer, xfer + views_of(g, src) * views_of(g, dst));
  g->out_edges[src].push_back(static_cast<int>(g->edges.size()));
  g->in_edges[dst].push_back(static_cast<int>(g->edges.size()));
  g->edges.push_back(std::move(e));
}

// Sum-with-overlap-credit evaluation: exactly the Python graph_cost().
double ffsim_eval(const SimGraph* g, const int* a, double overlap,
                  double* out_memory) {
  double compute = 0.0, comm = 0.0, mem = 0.0;
  for (int i = 0; i < g->n_nodes; ++i) {
    const int k = a[i];
    compute += g->compute[i][k];
    comm += g->comm[i][k] + g->sync[i][k];
    mem += g->memory[i][k];
  }
  for (const Edge& e : g->edges) {
    comm += e.xfer[a[e.src] * views_of(g, e.dst) + a[e.dst]];
  }
  if (out_memory) *out_memory = mem;
  return compute + comm * (1.0 - overlap);
}

// Event-driven two-channel list scheduling (reference simulate_runtime):
// compute tasks serialize on the compute channel, comm tasks (edge xfers +
// node collectives + weight-gradient syncs) on the ICI channel; a node
// starts when its inputs' xfers complete. Gradient syncs are scheduled on
// the comm channel as their producing node finishes — overlapping later
// compute exactly as XLA overlaps allreduce with the remaining backward
// wave — rather than summed as a serial tail.
double ffsim_simulate(const SimGraph* g, const int* a) {
  std::vector<int> indeg(g->n_nodes, 0);
  for (const Edge& e : g->edges) indeg[e.dst]++;
  std::vector<double> ready(g->n_nodes, 0.0);  // data-ready time per node
  // min-heap of (ready_time, node) — list scheduling by ready time
  using Item = std::pair<double, int>;
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> q;
  for (int i = 0; i < g->n_nodes; ++i)
    if (indeg[i] == 0) q.push({0.0, i});
  double compute_free = 0.0, comm_free = 0.0;
  double makespan = 0.0;
  while (!q.empty()) {
    auto [t, u] = q.top();
    q.pop();
    const int k = a[u];
    double start = std::max(t, compute_free);
    double end = start + g->compute[u][k];
    compute_free = end;
    if (g->comm[u][k] > 0.0) {  // node collective rides the ICI channel
      double cstart = std::max(end, comm_free);
      end = cstart + g->comm[u][k];
      comm_free = end;
    }
    makespan = std::max(makespan, end);
    for (int ei : g->out_edges[u]) {
      const Edge& e = g->edges[ei];
      double x = e.xfer[k * views_of(g, e.dst) + a[e.dst]];
      double arrive = end;
      if (x > 0.0) {
        double cstart = std::max(end, comm_free);
        arrive = cstart + x;
        comm_free = arrive;
      }
      ready[e.dst] = std::max(ready[e.dst], arrive);
      if (--indeg[e.dst] == 0) q.push({ready[e.dst], e.dst});
    }
    if (g->sync[u][k] > 0.0) {
      // grad allreduce: async on the comm channel, scheduled AFTER the
      // node's outgoing xfers — blocking activation transfers keep
      // priority, the allreduce fills the gaps (XLA's async collectives)
      double sstart = std::max(end, comm_free);
      double send = sstart + g->sync[u][k];
      comm_free = send;
      makespan = std::max(makespan, send);
    }
  }
  return makespan;
}

// Simulated-annealing search (reference mcmc_optimize): propose "random
// node -> random view", accept improving moves and worsening moves with
// prob exp(-alpha * relative_diff * 100). `assignment` holds the start
// state in and the best state out. Returns the number of accepted moves.
int ffsim_mcmc(const SimGraph* g, int budget, double alpha, uint64_t seed,
               double overlap, double memory_limit, int use_simulate,
               int* assignment, double* out_best_cost) {
  std::mt19937_64 rng(seed);
  std::vector<int> searchable;
  for (int i = 0; i < g->n_nodes; ++i)
    if (views_of(g, i) > 1) searchable.push_back(i);

  std::vector<int> cur(assignment, assignment + g->n_nodes);
  auto evaluate = [&](const int* a) {
    double mem = 0.0;
    double t = use_simulate ? ffsim_simulate(g, a) : ffsim_eval(g, a, overlap, &mem);
    if (use_simulate && memory_limit > 0.0)
      ffsim_eval(g, a, overlap, &mem);  // memory only needed for the penalty
    if (memory_limit > 0.0 && mem > memory_limit)
      t += 1e3 * (mem / memory_limit);
    return t;
  };
  double cur_cost = evaluate(cur.data());
  std::vector<int> best = cur;
  double best_cost = cur_cost;
  int accepted = 0;
  if (!searchable.empty()) {
    std::uniform_real_distribution<double> unif(0.0, 1.0);
    for (int it = 0; it < budget; ++it) {
      int node = searchable[rng() % searchable.size()];
      int view = static_cast<int>(rng() % views_of(g, node));
      int prev = cur[node];
      if (view == prev) continue;
      cur[node] = view;
      double nxt_cost = evaluate(cur.data());
      double diff = nxt_cost - cur_cost;
      if (diff < 0.0 ||
          unif(rng) <
              std::exp(-alpha * diff / std::max(cur_cost, 1e-12) * 100.0)) {
        cur_cost = nxt_cost;
        ++accepted;
        if (cur_cost < best_cost) {
          best_cost = cur_cost;
          best = cur;
        }
      } else {
        cur[node] = prev;  // reject
      }
    }
  }
  std::copy(best.begin(), best.end(), assignment);
  if (out_best_cost) *out_best_cost = best_cost;
  return accepted;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-device task-DAG simulator (reference Simulator::simulate_runtime,
// simulator.cc:822, with per-device SimTask queues and routed comm paths;
// ring expansion simulator.h:810).
//
// Channels are serial resources: one per chip (compute) plus one per
// mesh-axis ICI ring group (all rings of one axis carry identical traffic
// in an SPMD program, so one channel per axis captures both the axis's
// serialization and cross-collective contention on its links). Python
// expands a (graph, strategy) into tasks (flexflow_tpu/search/eventsim.py):
// lockstep ops become one task per chip, PIPELINE becomes stage x
// microbatch waves with ppermute hop tasks, ring attention becomes
// per-step block tasks chained by permute tasks. The whole DAG ships in
// one call (flat arrays) to keep ctypes overhead off the search loop.

namespace {

struct TaskSim {
  int n_channels = 0;
  std::vector<int> channel;        // per task; -1 = no resource (barrier)
  std::vector<double> duration;    // per task
  std::vector<std::vector<int>> succs;
  std::vector<int> indeg;
};

}  // namespace

extern "C" {

TaskSim* ffsim_tasksim_build(int n_channels, int n_tasks,
                             const int* channels, const double* durations,
                             int n_deps, const int* dep_src,
                             const int* dep_dst) {
  auto* s = new TaskSim();
  s->n_channels = n_channels;
  s->channel.assign(channels, channels + n_tasks);
  s->duration.assign(durations, durations + n_tasks);
  s->succs.resize(n_tasks);
  s->indeg.assign(n_tasks, 0);
  for (int i = 0; i < n_deps; ++i) {
    s->succs[dep_src[i]].push_back(dep_dst[i]);
    s->indeg[dep_dst[i]]++;
  }
  return s;
}

void ffsim_tasksim_destroy(TaskSim* s) { delete s; }

// Event-driven list scheduling: a task becomes ready when all deps
// finished; among ready tasks the earliest-ready runs first; each channel
// serializes its tasks. Returns the makespan (negative on a dependency
// cycle — tasks never all completed).
double ffsim_tasksim_run(TaskSim* s) {
  const int n = static_cast<int>(s->duration.size());
  std::vector<double> ready(n, 0.0);
  std::vector<int> indeg(s->indeg);
  using Item = std::pair<double, int>;
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> q;
  for (int i = 0; i < n; ++i)
    if (indeg[i] == 0) q.push({0.0, i});
  std::vector<double> chan_free(std::max(s->n_channels, 1), 0.0);
  double makespan = 0.0;
  int done = 0;
  while (!q.empty()) {
    auto [t, u] = q.top();
    q.pop();
    double start = t;
    const int c = s->channel[u];
    if (c >= 0) {
      start = std::max(start, chan_free[c]);
    }
    double end = start + s->duration[u];
    if (c >= 0) chan_free[c] = end;
    makespan = std::max(makespan, end);
    ++done;
    for (int v : s->succs[u]) {
      ready[v] = std::max(ready[v], end);
      if (--indeg[v] == 0) q.push({ready[v], v});
    }
  }
  return done == n ? makespan : -1.0;
}

}  // extern "C"
